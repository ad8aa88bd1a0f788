"""Replica read routing of the PyTorch port (pilosa_tpu_torch/parallel/
routing.py) against the JAX package's: the counterpart of
tests/test_routing.py.

Each case of tests/test_routing.py already runs on the port in another
file, so none is copied here:

* tests/test_torch_cluster_diff.py: the primary policy against the
  legacy grouping (``test_primary_policy_matches_legacy_grouping``),
  ``loaded`` with no history falling back to primary, the round-robin
  spread, the breaker skip and its all-open waiver, and the shard load
  tracker;
* tests/test_torch_balancer.py: ``loaded`` preferring the low-load
  replica, the residency preference with a budget-constrained replica,
  overlay epoch gating, and the 3-node cases (loaded vs primary under
  interleaved writes against an oracle, the skew corpus spreading the
  hot shard, the piggybacked load and residency folding, the local
  residency tiers, the balancer handoff with a state-wiped restart, and
  balancer off as static jump-hash).  The oracle of the loaded-vs-
  primary case is built with ``Executor(..., use_mesh=True)``, an
  argument only the JAX executor has; that file keeps it a JAX
  executor.

Here: the same replica choices under each policy.  A port ``Cluster``
and a JAX ``Cluster`` over the same placement (unopened, memory
holders) are fed the same router inputs — RTT history, reported load,
residency summaries, open breakers, a placement overlay — and must
group every shard of two indexes onto the same nodes, call after call.
"""

import pytest

pytest.importorskip("torch")

from pilosa_tpu.parallel.cluster import Cluster as JaxCluster  # noqa: E402
from pilosa_tpu.storage import Holder as JaxHolder  # noqa: E402
from pilosa_tpu_torch.parallel.cluster import Cluster  # noqa: E402
from pilosa_tpu_torch.storage import Holder  # noqa: E402

HOSTS = ["localhost:1", "localhost:2", "localhost:3", "localhost:4"]
SHARDS = list(range(48))
INDEXES = ("i", "sk")


def _history(cl, rtts):
    for nid, rtt in rtts.items():
        cl.router.note_dispatch(nid, 1)
        cl.router.note_done(nid, rtt)


def _primary(cl):
    cl.router.policy = "primary"


def _loaded_history(cl):
    cl.router.policy = "loaded"
    cl.router.residency_routing = False
    _history(cl, {"node1": 0.01, "node2": 0.02, "node3": 0.005})


def _loaded_overloaded(cl):
    _loaded_history(cl)
    cl.router.note_query_load("node3", {"inFlight": 50, "queued": 10})
    cl.router.note_query_load("node1", {"inFlight": 2, "queued": 0})


def _residency(cl):
    cl.router.policy = "loaded"
    cl.router.residency_routing = True
    _history(cl, {"node1": 0.01, "node2": 0.01, "node3": 0.01})
    cl.router.note_status("node1", {"residency": {
        "i": {"hbm": SHARDS[::3], "host": SHARDS[1::3]}}})
    cl.router.note_status("node2", {"residency": {
        "i": {"hbm": SHARDS[1::4], "host": []},
        "sk": {"hbm": SHARDS[::2], "host": SHARDS[1::2]}}})
    cl.router.note_status("node3", {"residency": {}})


def _residency_off(cl):
    _residency(cl)
    cl.router.residency_routing = False


def _breaker_open(cl):
    cl.router.policy = "primary"
    cl.client._breaker(cl.by_id["node2"].host).state = "open"


def _overlay(cl):
    cl.router.policy = "loaded"
    _history(cl, {"node1": 0.03, "node2": 0.01, "node3": 0.02})
    cl._apply_overlay({"epoch": 2, "overlay": [
        ["i", s, [n]] for s, n in ((3, "node3"), (7, "node1"),
                                   (11, "node2"), (20, "node3"))]})


def _round_robin(cl):
    cl.router.policy = "round-robin"


SCENARIOS = {
    "primary": _primary,
    "loaded_history": _loaded_history,
    "loaded_overloaded": _loaded_overloaded,
    "residency": _residency,
    "residency_off": _residency_off,
    "breaker_open": _breaker_open,
    "overlay": _overlay,
    "round_robin": _round_robin,
}


def _choices(cl, scenario):
    """Three rounds of groupings for every shard of both indexes, one
    shard at a time and all together, plus the hedge candidates."""
    SCENARIOS[scenario](cl)
    out = []
    for _ in range(3):
        for index in INDEXES:
            out.append(cl.router.group_shards(index, SHARDS))
            out.append([cl.router.group_shards(index, [s])
                        for s in SHARDS])
            out.append([cl.router.hedge_candidate(index, [s], {"node1"})
                        for s in SHARDS])
    out.append([(n.id, n.state) for n in cl.nodes])
    out.append(cl.router.breaker_skips)
    return out


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_replica_choices_match_jax(scenario):
    got = []
    for cls, holder_cls in ((JaxCluster, JaxHolder), (Cluster, Holder)):
        cl = cls("node0", HOSTS, replica_n=2, holder=holder_cls(None))
        try:
            got.append(_choices(cl, scenario))
        finally:
            cl.close()
    jax_out, port_out = got
    assert port_out == jax_out
    # every shard is grouped exactly once, onto one of its owners
    assert sorted(sum(port_out[0].values(), [])) == SHARDS
