"""Differential tests of the PyTorch port's node-to-node wire: the
PTPUQRY1 codec (pilosa_tpu_torch/parallel/qwire.py), the JSON call codec
(pql/wire.py) and shard placement (parallel/placement.py) against the
JAX package's.

For every result shape of tests/test_qwire.py and for a request frame,
the same seeded inputs are built as each package's result objects and
encoded by each package's codec: the frames must be byte-identical.
The port's codec also passes the corruption, endianness and
frame-ceiling cases, and the port's ``Placement`` gives the JAX one's
owners for 1,000 seeded (index, shard) pairs at ``replica_n`` 1, 2 and 3.

Every comparison is EXACT (bytes, integers).
"""

import numpy as np
import pytest

from pilosa_tpu.executor import results as jax_results
from pilosa_tpu.parallel import cluster as jax_cluster
from pilosa_tpu.parallel import placement as jax_placement
from pilosa_tpu.parallel import qwire as jax_qwire
from pilosa_tpu.pql import parse as jax_parse
from pilosa_tpu.pql import wire as jax_pwire
from pilosa_tpu_torch.core import SHARD_WORDS
from pilosa_tpu_torch.executor import results as port_results
from pilosa_tpu_torch.parallel import cluster as port_cluster
from pilosa_tpu_torch.parallel import placement as port_placement
from pilosa_tpu_torch.parallel import qwire
from pilosa_tpu_torch.pql import parse as port_parse
from pilosa_tpu_torch.pql import wire as port_pwire


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _seg(rng, nwords=30):
    s = np.zeros(SHARD_WORDS, dtype=np.uint32)
    idx = rng.choice(SHARD_WORDS, nwords, replace=False)
    s[idx] = rng.integers(1, 2**32, nwords, dtype=np.uint64).astype(
        np.uint32)
    return s


def _shapes(R, segs):
    """Every result shape of tests/test_qwire.py, built from package
    ``R``'s result classes over the shared segments."""
    s0, s5, run, dense = segs
    return [
        R.RowResult({0: s0, 5: s5}, attrs={"a": 1}),
        R.RowResult({2: run, 3: dense}),
        R.RowResult({}),
        R.ValCount(42, 7),
        R.ValCount(2.5, 3),
        R.ValCount(None, 0),
        R.RowIdentifiers(rows=[1, 5, 9]),
        R.RowIdentifiers(rows=[], keys=["x", "y"]),
        [R.Pair(1, 10), R.Pair(2, 5)],
        [R.Pair(7, 9, "k1"), R.Pair(8, 4, "k2")],
        [],
        [R.GroupCount([R.FieldRow("f", 1)], 3)],
        123,
        None,
    ]


def _segs(rng):
    run = np.zeros(SHARD_WORDS, dtype=np.uint32)
    run[100:6000] = 0xFFFFFFFF
    dense = rng.integers(0, 2**32, SHARD_WORDS, dtype=np.uint64).astype(
        np.uint32)
    return _seg(rng), _seg(rng, 400), run, dense


TRAILER = {"execS": 0.01, "gens": [["f", 3]], "quarantined": 1,
           "load": {"inFlight": 0, "queued": 0}, "spans": []}


def test_every_result_shape_frames_byte_identical(rng):
    segs = _segs(rng)
    jres = _shapes(jax_results, segs)
    pres = _shapes(port_results, segs)
    for j, p in zip(jres, pres):
        assert qwire.encode_result(p) == jax_qwire.encode_result(j)
        assert port_cluster.result_to_wire(p) == \
            jax_cluster.result_to_wire(j)
    jbody, jn = jax_qwire.encode_response(jres, TRAILER)
    pbody, pn = qwire.encode_response(pres, TRAILER)
    assert pbody == jbody and pn == jn == len(pres) + 1
    # each package decodes the other's frames to the same meaning
    got, trailer, _ = qwire.decode_response(jbody)
    assert trailer == TRAILER
    assert [port_cluster.result_to_wire(r) for r in got] == \
        [jax_cluster.result_to_wire(r) for r in jres]
    got_j, _, _ = jax_qwire.decode_response(pbody)
    assert [jax_cluster.result_to_wire(r) for r in got_j] == \
        [port_cluster.result_to_wire(r) for r in pres]


def test_device_segment_words_reach_the_wire_as_uint32(rng):
    """A segment fetched from the device as int32 bit patterns and
    viewed as uint32 (ops/bitset.py ``to_numpy``) encodes exactly as the
    JAX package's uint32 segment does."""
    import torch

    from pilosa_tpu_torch.ops import bitset
    seg = _seg(rng, 500)
    seg[7] = 0xFFFFFFFF    # sign bit set: int32 -1 on the device
    t = bitset.from_numpy(seg, "cpu")
    assert t.dtype == torch.int32 and int(t[7]) == -1
    host = bitset.to_numpy(t)
    assert host.dtype == np.uint32
    assert qwire.encode_result(port_results.RowResult({3: host})) == \
        jax_qwire.encode_result(jax_results.RowResult({3: seg}))


def test_request_frames_byte_identical():
    pql = ("Count(Intersect(Row(f=3), Row(g=1))) "
           "TopN(metric, Intersect(Row(seg=0), Row(seg=2)), n=5) "
           "Sum(Row(v > 17), field=v) Row(-20 < v < 30) "
           "GroupBy(Rows(a), Rows(b), Row(c=1))")
    jcalls = [jax_pwire.call_to_wire(c) for c in jax_parse(pql).calls]
    pcalls = [port_pwire.call_to_wire(c) for c in port_parse(pql).calls]
    assert pcalls == jcalls
    for shards in ([0, 3, 1 << 40], None, []):
        assert qwire.encode_request(pcalls, shards) == \
            jax_qwire.encode_request(jcalls, shards)
    got, shards, n = qwire.decode_request(
        jax_qwire.encode_request(jcalls, [1, 2]))
    assert got == jcalls and shards == [1, 2] and n == 2
    # the JSON call codec round-trips to the same call tree
    back = [port_pwire.call_from_wire(c) for c in pcalls]
    assert [str(c) for c in back] == \
        [str(c) for c in port_parse(pql).calls]


def test_segment_encoding_choice(rng):
    sparse = _seg(rng, 20)
    enc, blob = qwire.encode_segment(sparse)
    assert (enc, blob) == jax_qwire.encode_segment(sparse)
    assert enc == qwire.SEG_PACKED
    assert np.array_equal(qwire.decode_segment(enc, blob), sparse)
    dense = rng.integers(0, 2**32, SHARD_WORDS, dtype=np.uint64).astype(
        np.uint32)
    enc, blob = qwire.encode_segment(dense)
    assert enc == qwire.SEG_RAW and len(blob) == SHARD_WORDS * 4
    assert np.array_equal(qwire.decode_segment(enc, blob), dense)


def test_endianness_tag_rejected(rng):
    body, _ = qwire.encode_response(
        [port_results.RowResult({0: _seg(rng)})], {})
    frames = list(qwire.iter_frames(body))
    payload = bytearray(bytes(frames[0]))
    assert payload[0] == qwire.REC_ROW and payload[1] == qwire.ENDIAN_LE
    payload[1] = 1
    rebuilt = qwire.MAGIC + qwire.encode_frame(bytes(payload)) \
        + qwire.encode_frame(bytes(frames[1]))
    with pytest.raises(qwire.FrameError, match="little-endian"):
        qwire.decode_response(rebuilt)


def _walk(body, decode):
    """Flip one bit at every byte and truncate at every length: decode
    must reject, never yield the same answer silently."""
    want = decode(body)
    for off in range(len(body)):
        bad = bytearray(body)
        bad[off] ^= 0x10
        try:
            got = decode(bytes(bad))
        except qwire.FrameError:
            continue
        assert got != want, f"corruption at byte {off} went undetected"
    for cut in range(len(body)):
        try:
            got = decode(body[:cut])
        except qwire.FrameError:
            continue
        assert got != want, f"truncation to {cut} bytes went undetected"


def test_request_every_byte_corruption_rejected(rng):
    body = qwire.encode_request(
        [{"name": "Row", "args": {"f": int(rng.integers(0, 50))}}],
        [0, 2, 5])
    _walk(body, lambda d: qwire.decode_request(d)[:2])


def test_response_every_byte_corruption_rejected(rng):
    body, _ = qwire.encode_response(
        [port_results.RowResult({0: _seg(rng, 8)}),
         port_results.ValCount(9, 2)],
        {"execS": 0.5, "load": {"inFlight": 1, "queued": 0}})

    def decode(d):
        results, trailer, _ = qwire.decode_response(d)
        return [port_cluster.result_to_wire(r) for r in results], trailer

    _walk(body, decode)


def test_frame_ceiling_and_junk():
    with pytest.raises(qwire.FrameError, match="magic"):
        list(qwire.iter_frames(b"NOTMAGIC" + b"\x00" * 16))
    with pytest.raises(qwire.FrameError):
        list(qwire.iter_frames(b"PT"))
    huge = qwire.MAGIC + qwire.FRAME.pack(qwire.MAX_FRAME_BYTES + 1, 0)
    with pytest.raises(qwire.FrameError, match="outside"):
        list(qwire.iter_frames(huge))
    naked = qwire.MAGIC + qwire.encode_frame(
        qwire.encode_result(port_results.ValCount(1, 1)))
    with pytest.raises(qwire.FrameError, match="trailer"):
        qwire.decode_response(naked)


@pytest.mark.parametrize("replica_n", [1, 2, 3])
def test_placement_owners_match(replica_n):
    nodes = [f"node{i}" for i in range(5)]
    jp = jax_placement.Placement(nodes, replica_n=replica_n)
    pp = port_placement.Placement(nodes, replica_n=replica_n)
    rng = np.random.default_rng(100 + replica_n)
    names = ["i", "ssb1b", "dist", "a-much-longer-index-name"]
    for _ in range(1000):
        index = names[int(rng.integers(0, len(names)))]
        shard = int(rng.integers(0, 1 << 20))
        owners = pp.shard_nodes(index, shard)
        assert owners == jp.shard_nodes(index, shard)
        assert len(owners) == replica_n
    shards = list(range(300))
    for nid in nodes:
        assert pp.owned_shards(nid, "dist", shards) == \
            jp.owned_shards(nid, "dist", shards)
