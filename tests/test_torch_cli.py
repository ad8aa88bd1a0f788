"""The PyTorch port's CLI (pilosa_tpu_torch/cli.py): the counterpart of
tests/test_cli.py, against port servers with ``device="cpu"``.
Import/export round-trips against a live server and a 3-node cluster,
check/inspect on fragment files, the resolved config and
generate-config.

Differential: ``config`` prints the JAX CLI's resolved configuration
apart from the port's ``device`` line, and ``generate-config`` names
the JAX CLI's keys plus ``device``.
"""

import json

import pytest

pytest.importorskip("torch")

from pilosa_tpu_torch.cli import main  # noqa: E402
from pilosa_tpu_torch.server.server import Config as _Config  # noqa: E402
from pilosa_tpu_torch.server.server import Server  # noqa: E402

from test_torch_cluster import make_cluster, restore_knobs  # noqa: E402, F401
from test_torch_cluster_obs import Config  # noqa: E402


@pytest.fixture
def srv(tmp_path):
    s = Server(Config(data_dir=str(tmp_path / "data"), bind="localhost:0"))
    s.open()
    yield s
    s.close()


def test_import_export_roundtrip(srv, tmp_path, capsys):
    csv = tmp_path / "in.csv"
    csv.write_text("1,10\n1,20\n2,1048586\n")
    rc = main(["import", "-host", f"localhost:{srv.port}",
               "-i", "x", "-f", "f", "--create", str(csv)])
    assert rc == 0
    out = tmp_path / "out.csv"
    rc = main(["export", "-host", f"localhost:{srv.port}",
               "-i", "x", "-f", "f", "-o", str(out)])
    assert rc == 0
    assert set(out.read_text().strip().split("\n")) == \
        {"1,10", "1,20", "2,1048586"}


def test_cluster_export_covers_remote_shards(tmp_path):
    """Export through ONE node must fetch each shard from an owner —
    shards placed on other nodes are not silently dropped
    (ctl/export.go fragment-nodes routing)."""
    servers = make_cluster(tmp_path, n=3, replica_n=1)
    try:
        from pilosa_tpu_torch.core import SHARD_WIDTH
        csv = tmp_path / "in.csv"
        lines = [f"1,{s * SHARD_WIDTH + 7}" for s in range(8)]
        csv.write_text("\n".join(lines) + "\n")
        p0 = servers[0].port
        rc = main(["import", "-host", f"localhost:{p0}",
                   "-i", "x", "-f", "f", "--create", str(csv)])
        assert rc == 0
        # replica_n=1: some of the 8 shards live only on nodes 1/2
        owned0 = {s for s in range(8)
                  if "node0" in
                  servers[0].cluster.placement.shard_nodes("x", s)}
        assert owned0 != set(range(8))
        out = tmp_path / "out.csv"
        rc = main(["export", "-host", f"localhost:{p0}",
                   "-i", "x", "-f", "f", "-o", str(out)])
        assert rc == 0
        assert set(out.read_text().strip().split("\n")) == set(lines)
    finally:
        for s in servers:
            s.close()


def test_import_int_field(srv, tmp_path):
    csv = tmp_path / "vals.csv"
    csv.write_text("1,100\n2,-5\n")
    rc = main(["import", "-host", f"localhost:{srv.port}",
               "-i", "x", "-f", "v", "--create", "--field-type", "int",
               "--min", "-100", "--max", "1000", str(csv)])
    assert rc == 0
    import urllib.request
    req = urllib.request.Request(
        f"http://localhost:{srv.port}/index/x/query",
        data=b"Sum(field=v)", method="POST")
    body = json.loads(urllib.request.urlopen(req).read())
    assert body["results"][0] == {"value": 95, "count": 2}


def test_check_and_inspect(tmp_path, capsys):
    from pilosa_tpu_torch.storage.fragment import Fragment

    path = str(tmp_path / "frag")
    f = Fragment(path, "i", "f", "standard", 0)
    f.set_bit(1, 100)
    f.close()
    assert main(["check", path]) == 0
    out = capsys.readouterr().out
    assert "OK" in out
    assert main(["inspect", path]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["bits"] == 1

    # corrupt it
    with open(path, "r+b") as fh:
        fh.write(b"XXXXXXXX")
    assert main(["check", path]) == 1
    assert "CORRUPT" in capsys.readouterr().out


def test_config_resolved(tmp_path, capsys, monkeypatch):
    """`config` prints the resolved cascade: TOML overridden by env."""
    toml = tmp_path / "c.toml"
    toml.write_text('data-dir = "/tmp/x"\nbind = "localhost:7777"\n')
    monkeypatch.setenv("PILOSA_TPU_BIND", "localhost:8888")
    rc = main(["config", "-c", str(toml)])
    assert rc == 0
    out = capsys.readouterr().out
    assert 'data-dir = "/tmp/x"' in out       # from TOML
    assert 'bind = "localhost:8888"' in out   # env wins over TOML
    assert "[cluster]" in out
    # round-trips: the printed output parses as the same config
    rt = tmp_path / "rt.toml"
    rt.write_text(out)
    monkeypatch.delenv("PILOSA_TPU_BIND")
    cfg = _Config.from_toml(str(rt))
    assert cfg.bind == "localhost:8888"
    assert cfg.data_dir == "/tmp/x"


def test_generate_config(capsys):
    assert main(["generate-config"]) == 0
    out = capsys.readouterr().out
    assert "data-dir" in out
    from pilosa_tpu_torch.utils import toml
    toml.loads(out)  # valid TOML (tomllib, or tomli on py3.10)


def test_import_create_idempotent(srv, tmp_path):
    csv = tmp_path / "a.csv"
    csv.write_text("1,1\n")
    for _ in range(2):  # second run hits 409 on create; must succeed
        assert main(["import", "-host", f"localhost:{srv.port}",
                     "-i", "y", "-f", "f", "--create", str(csv)]) == 0


def test_import_batching(srv, tmp_path):
    csv = tmp_path / "b.csv"
    csv.write_text("".join(f"1,{i}\n" for i in range(25)))
    assert main(["import", "-host", f"localhost:{srv.port}", "-i", "z",
                 "-f", "f", "--create", "--batch-size", "10", str(csv)]) == 0
    import urllib.request
    req = urllib.request.Request(
        f"http://localhost:{srv.port}/index/z/query",
        data=b"Count(Row(f=1))", method="POST")
    assert json.loads(urllib.request.urlopen(req).read())["results"] == [25]


def test_config_output_matches_jax(tmp_path, capsys, monkeypatch):
    """The resolved cascade prints as the JAX CLI prints it, but for the
    port's ``device`` line."""
    from pilosa_tpu.cli import main as jax_main

    toml = tmp_path / "c.toml"
    toml.write_text('data-dir = "/tmp/x"\nbind = "localhost:7777"\n'
                    '[cluster]\nreplicas = 2\n')
    monkeypatch.setenv("PILOSA_TPU_BIND", "localhost:8888")
    outs = []
    for fn in (jax_main, main):
        assert fn(["config", "-c", str(toml)]) == 0
        outs.append(capsys.readouterr().out.splitlines())
    jax_out, port_out = outs
    assert 'device = "cuda"' in port_out
    assert [ln for ln in port_out if ln != 'device = "cuda"'] == jax_out


def test_generate_config_keys_match_jax(capsys):
    from pilosa_tpu.cli import main as jax_main
    from pilosa_tpu_torch.utils import toml

    def keys(d, prefix=""):
        out = set()
        for k, v in d.items():
            out.add(prefix + k)
            if isinstance(v, dict):
                out |= keys(v, prefix + k + ".")
        return out

    got = []
    for fn in (jax_main, main):
        assert fn(["generate-config"]) == 0
        got.append(keys(toml.loads(capsys.readouterr().out)))
    assert got[1] == got[0] | {"device"}
