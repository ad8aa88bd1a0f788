"""Topology persistence of the PyTorch port's cluster
(pilosa_tpu_torch/parallel/cluster.py, ``.topology``) against the JAX
package's: the counterpart of tests/test_topology.py.

Each case of tests/test_topology.py already runs on port nodes in
tests/test_torch_resize.py, so none is copied here: the topology
persisting across a full restart (``test_topology_persists_across_restart``,
:234), a mismatched topology refused (:265), the straggler re-converged
by the probe, the coordinator crash between the two resize phases, the
removed node's recovery and its probe safety net, and the stale
resizing latch.  That file's mixed JAX + port cluster also compares the
two packages' ``.topology`` files after a live grow and shrink.

Here, unit by unit and without sockets: the same resize-complete and
placement-overlay messages, applied to a port ``Cluster`` and a JAX
``Cluster`` over data directories, leave byte-identical ``.topology``
files after every step; each package adopts the other's file with the
same membership, epoch, placement and overlay; and both refuse a
topology that does not name the node, with the same message.
"""

import os
import shutil

import pytest

pytest.importorskip("torch")

from pilosa_tpu.parallel.cluster import Cluster as JaxCluster  # noqa: E402
from pilosa_tpu.parallel.cluster import \
    ClusterError as JaxClusterError  # noqa: E402
from pilosa_tpu.storage import Holder as JaxHolder  # noqa: E402
from pilosa_tpu_torch.parallel.cluster import (  # noqa: E402
    Cluster, ClusterError)
from pilosa_tpu_torch.storage import Holder  # noqa: E402

HOSTS = ["localhost:1", "localhost:2", "localhost:3"]
PACKAGES = {"jax": (JaxCluster, JaxHolder, JaxClusterError),
            "port": (Cluster, Holder, ClusterError)}


def _members(n):
    return [{"id": f"node{i}", "uri": f"localhost:{i + 1}"}
            for i in range(n)]


STEPS = [
    ("grow", {"type": "resize-complete", "epoch": 1, "replicaN": 2,
              "membership": _members(4)}),
    ("overlay", {"epoch": 2, "overlay": [["i", 3, ["node3"]],
                                          ["i", 9, ["node1"]],
                                          ["j", 0, ["node2"]]]}),
    ("overlay-stale", {"epoch": 1, "overlay": []}),
    ("replica", {"type": "resize-complete", "epoch": 2, "replicaN": 3,
                 "membership": _members(4)}),
    ("overlay", {"epoch": 9, "overlay": [["i", 5, ["node0"]]]}),
    ("shrink", {"type": "resize-complete", "epoch": 3, "replicaN": 2,
                "membership": _members(3)}),
    ("duplicate", {"type": "resize-complete", "epoch": 3, "replicaN": 1,
                   "membership": _members(2)}),
]


def _cluster(tag, data_dir, hosts=HOSTS):
    cls, holder_cls, _ = PACKAGES[tag]
    return cls("node0", hosts, replica_n=2, holder=holder_cls(data_dir))


def _apply(cl, kind, msg):
    if kind.startswith("overlay"):
        cl._apply_overlay(msg)
    else:
        cl._apply_resize_complete(msg)


def _view(cl):
    return ([(n.id, n.host) for n in cl.nodes], cl.epoch, cl.replica_n,
            [cl.placement.shard_nodes("i", s) for s in range(32)],
            cl.overlay_epoch,
            [cl.shard_owner_nodes("i", s) for s in range(12)])


def test_topology_bytes_match_jax_step_by_step(tmp_path):
    clusters = {tag: _cluster(tag, str(tmp_path / tag))
                for tag in PACKAGES}
    try:
        for step, (kind, msg) in enumerate(STEPS):
            files = {}
            for tag, cl in clusters.items():
                _apply(cl, kind, msg)
                with open(tmp_path / tag / ".topology", "rb") as f:
                    files[tag] = f.read()
            assert files["port"] == files["jax"], (step, kind)
            assert _view(clusters["port"]) == _view(clusters["jax"])
    finally:
        for cl in clusters.values():
            cl.close()
    assert clusters["port"].epoch == 3
    assert len(clusters["port"].nodes) == 3


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_topology_adopted_across_packages(tmp_path, writer, reader):
    """A node restarted under the other package, its config still
    listing the stale host list, adopts the persisted membership."""
    src = _cluster(writer, str(tmp_path / "w"))
    try:
        for kind, msg in STEPS[:5]:
            _apply(src, kind, msg)
        want = _view(src)
    finally:
        src.close()
    shutil.copytree(tmp_path / "w", tmp_path / "r")
    dst = _cluster(reader, str(tmp_path / "r"), hosts=HOSTS[:2])
    try:
        assert _view(dst) == want
        dst._save_topology()
        with open(tmp_path / "w" / ".topology", "rb") as a, \
                open(tmp_path / "r" / ".topology", "rb") as b:
            assert a.read() == b.read()
    finally:
        dst.close()


def test_topology_mismatch_refused_alike(tmp_path):
    """A persisted topology that does not name this node: both packages
    refuse to start, with the same message."""
    msgs = {}
    for tag, (_, _, err) in PACKAGES.items():
        d = tmp_path / tag
        os.makedirs(d)
        with open(d / ".topology", "w") as f:
            f.write('{"epoch": 3, "replicaN": 1, "membership": '
                    '[{"id": "nodeX", "uri": "localhost:9"}]}')
        with pytest.raises(err, match="not in the persisted") as ei:
            _cluster(tag, str(d))
        msgs[tag] = str(ei.value).replace(str(d), "<dir>")
    assert msgs["port"] == msgs["jax"]
