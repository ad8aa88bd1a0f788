"""Differential tests of the PyTorch port's PQL parser
(pilosa_tpu_torch/pql) and of its untrusted-bytes decoders against the
JAX package's: the counterparts of tests/test_pql.py and
tests/test_fuzz.py.

Every happy-path text of tests/test_pql.py (the pqlpeg_test.go vectors
and the structural cases) is parsed by both packages and the ASTs'
``repr`` must be equal; every rejected text must raise ``ParseError`` in
both, with the same message.  The structural assertions then run on the
port's AST.  A seeded mutation fuzz of those texts holds the two parsers
to the same outcome on every mutant.

The fuzz cases of tests/test_fuzz.py run on the port, and each mutated
roaring blob and WAL buffer also goes through the JAX package: both must
accept it with the same rows and columns, or both must reject it.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from pilosa_tpu import pql as jpql  # noqa: E402
from pilosa_tpu.storage import fragment as jfragment  # noqa: E402
from pilosa_tpu.storage import roaring_io as jroaring  # noqa: E402
from pilosa_tpu_torch import pql  # noqa: E402
from pilosa_tpu_torch.core import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.pql import BETWEEN, Condition  # noqa: E402
from pilosa_tpu_torch.storage import roaring_io as proaring  # noqa: E402
from pilosa_tpu_torch.storage.fragment import (  # noqa: E402
    _OP, _OP_CLEAR, _OP_SET, Fragment)
from pilosa_tpu_torch.storage.roaring_io import (  # noqa: E402
    RoaringFormatError, pack_roaring, unpack_roaring)

# (input, expected number of top-level calls): pqlpeg_test.go:79-303
HAPPY = [
    ("", 0),
    ("Set(2, f=10)", 1),
    ("Set('foo', f=10)", 1),
    ('Set("foo", f=10)', 1),
    ("Set(2, f=1, 1999-12-31T00:00)", 1),
    ("Set(1, a=4)Set(2, a=4)", 2),
    ("Set(1, a=4) Set(2, a=4)", 2),
    ("Set(1, a=4) \n Set(2, a=4)", 2),
    ("Set(1, a=4)Blerg(z=ha)", 2),
    ("Set(1, a=4)Blerg(z=ha)Set(2, z=99)", 3),
    ("Arb(q=1, a=4)Set(1, z=9)Arb(z=99)", 3),
    ("Set(1, a=zoom)", 1),
    ("Set(1, a=4, b=5)", 1),
    ("Set(1, a=4, bsd=haha)", 1),
    ("Set(1, a=4, 2017-04-03T19:34)", 1),
    ("Union()", 1),
    ("Union(Row(a=1))", 1),
    ("Union(Row(a=1), Row(z=44))", 1),
    ("Union(Intersect(Row(), Union(Row(), Row())), Row())", 1),
    ("TopN(boondoggle)", 1),
    ("TopN(boon, doggle=9)", 1),
    ('B(a="zm\'\'e")', 1),
    ("B(a='zm\"\"e')", 1),
    ("SetRowAttrs(blah, 9, a=47)", 1),
    ("SetRowAttrs(blah, 9, a=47, b=bval)", 1),
    ("SetRowAttrs(blah, 'rowKey', a=47)", 1),
    ('SetRowAttrs(blah, "rowKey", a=47)', 1),
    ("SetColumnAttrs(9, a=47)", 1),
    ("SetColumnAttrs(9, a=47, b=bval)", 1),
    ("SetColumnAttrs('colKey', a=47)", 1),
    ('SetColumnAttrs("colKey", a=47)', 1),
    ("Clear(1, a=53)", 1),
    ("Clear(1, a=53, b=33)", 1),
    ("TopN(myfield, n=44)", 1),
    ("TopN(myfield, Row(a=47), n=10)", 1),
    ("Row(a < 4)", 1),
    ("Row(a > 4)", 1),
    ("Row(a <= 4)", 1),
    ("Row(a >= 4)", 1),
    ("Row(a == 4)", 1),
    ("Row(a != null)", 1),
    ("Row(4 < a < 9)", 1),
    ("Row(4 < a <= 9)", 1),
    ("Row(4 <= a < 9)", 1),
    ("Row(4 <= a <= 9)", 1),
    ("Row(a=4, from=2010-07-04T00:00, to=2010-08-04T00:00)", 1),
    ("Row(a=4, from='2010-07-04T00:00', to=\"2010-08-04T00:00\")", 1),
    ("Row(a=4, from='2010-07-04T00:00')", 1),
    ("Row(a=4, to=\"2010-08-04T00:00\")", 1),
    ("Set(1, my-frame=9)", 1),
    ("Set(\n1,\nmy-frame\n=9)", 1),
    ("Range(blah=1, 2019-04-07T00:00, 2019-08-07T00:00)", 1),
]

# error cases: pqlpeg_test.go:304-341 TestPEGErrors, plus extras
BAD = [
    "Set",
    "Set(1, a=4, 2017-94-03T19:34)",
    "Set(1, 2017-04-03T19:34)",
    "Set(, 1, a=4)",
    "Zeeb(, a=4)",
    "SetRowAttrs(blah, 9)",
    "Clear(9)",
    "Row(a>4, 2010-07-04T00:00, 2010-08-04T00:00)",
    "Row(a=4, 2010-07-04T00:00)",
    "Row(a=9223372036854775808)",
    "Row(a=-9223372036854775809)",
    "Set()haha",
    "Set(1, a=4)'",
    "Set(a=4)",
    "Set(1, b=5",
    ", Blerg()",
    "SetRowAttrs(blah)",
    "Clear()",
    "Row(a=1, a=2)",
]


def _outcome(mod, text):
    """(repr of the AST, None) or (None, (error class name, message))."""
    try:
        return repr(mod.parse(text)), None
    except mod.ParseError as e:
        return None, (type(e).__name__, str(e))


@pytest.mark.parametrize("text,ncalls", HAPPY)
def test_parse_happy_matches_jax(text, ncalls):
    q = pql.parse(text)
    assert len(q.calls) == ncalls, repr(q)
    assert repr(q) == repr(jpql.parse(text))


@pytest.mark.parametrize("text", BAD)
def test_parse_errors_match_jax(text):
    with pytest.raises(pql.ParseError):
        pql.parse(text)
    assert _outcome(pql, text) == _outcome(jpql, text)


def _check_set(q):
    c = q.calls[0]
    assert c.name == "Set"
    assert c.args["_col"] == 2
    assert c.args["f"] == 10
    assert c.args["_timestamp"] == "1999-12-31T00:00"


def _check_nested(q):
    c = q.calls[0]
    assert c.name == "Intersect"
    assert [ch.name for ch in c.children] == ["Row", "Union"]
    assert c.children[1].children[0].args["b"] == 2
    assert c.args["x"] == 7


def _check_condition(q):
    cond = q.calls[0].args["a"]
    assert isinstance(cond, Condition)
    assert cond.op == "<="
    assert cond.value == 4


def _check_between_lower(q):
    cond = q.calls[0].args["a"]
    assert cond.op == BETWEEN
    assert cond.value == [5, 9]


def _check_between_upper(q):
    assert q.calls[0].args["a"].value == [4, 8]


def _check_topn(q):
    c = q.calls[0]
    assert c.args["_field"] == "myfield"
    assert c.children[0].name == "Row"
    assert c.args["n"] == 10


def _check_store(q):
    c = q.calls[0]
    assert c.name == "Store"
    assert c.children[0].name == "Row"
    assert c.args["b"] == 2


def _check_rows(q):
    c = q.calls[0]
    assert c.args["_field"] == "f"
    assert c.args["previous"] == 10
    assert c.args["limit"] == 5


def _check_values(q):
    a = q.calls[0].args
    assert a["a"] is None
    assert a["b"] is True
    assert a["c"] is False
    assert a["d"] == -5
    assert a["e"] == 1.25
    assert a["f"] == "word"
    assert a["g"] == "q s"
    assert a["h"] == [1, 2, 3]
    assert a["i"] == "a:b-c_d"


def _check_escape(q):
    assert q.calls[0].args["a"] == 'x"y'


def _check_clearrow(q):
    assert q.calls[0].args["f"] == 5


def _check_range(q):
    c = q.calls[0]
    assert c.args["blah"] == 1
    assert c.args["from"] == "2019-04-07T00:00"
    assert c.args["to"] == "2019-08-07T00:00"


def _check_writes(q):
    assert [c.name for c in q.write_calls()] == ["Set"]


# the structural assertions of tests/test_pql.py, one case each
STRUCTURE = [
    ("Set(2, f=10, 1999-12-31T00:00)", _check_set),
    ("Intersect(Row(a=1), Union(Row(b=2), Row(c=3)), x=7)", _check_nested),
    ("Row(a <= 4)", _check_condition),
    ("Row(4 < a <= 9)", _check_between_lower),
    ("Row(4 <= a < 9)", _check_between_upper),
    ("TopN(myfield, Row(a=47), n=10)", _check_topn),
    ("Store(Row(a=1), b=2)", _check_store),
    ("Rows(f, previous=10, limit=5, column=3)", _check_rows),
    ('F(a=null, b=true, c=false, d=-5, e=1.25, f=word, g="q s", '
     "h=[1,2,3], i=a:b-c_d)", _check_values),
    ('F(a="x\\"y")', _check_escape),
    ("ClearRow(f=5)", _check_clearrow),
    ("Range(blah=1, 2019-04-07T00:00, 2019-08-07T00:00)", _check_range),
    ("Set(1, a=2)Count(Row(a=2))", _check_writes),
]


@pytest.mark.parametrize("text,check", STRUCTURE,
                         ids=[c.__name__[7:] for _, c in STRUCTURE])
def test_structure(text, check):
    q = pql.parse(text)
    check(q)
    assert repr(q) == repr(jpql.parse(text))


def test_fuzz_parse_mutations_match_jax():
    """Seeded byte-level mutants of every happy and rejected text: the
    two parsers give the same AST or the same error on each."""
    rng = np.random.default_rng(2024)
    alphabet = "()=,<>!'\"[]:-_ .\n0123456789aAfnTRSr"
    texts = [t for t, _ in HAPPY if t] + BAD
    for i in range(3000):
        s = list(texts[i % len(texts)])
        for _ in range(int(rng.integers(1, 4))):
            op = int(rng.integers(0, 3))
            pos = int(rng.integers(0, len(s) + 1))
            if op == 0 and s:
                del s[min(pos, len(s) - 1)]
            elif op == 1:
                s.insert(pos, alphabet[int(rng.integers(0, len(alphabet)))])
            elif s:
                s[min(pos, len(s) - 1)] = alphabet[
                    int(rng.integers(0, len(alphabet)))]
        text = "".join(s)
        assert _outcome(pql, text) == _outcome(jpql, text), text


# -- tests/test_fuzz.py ------------------------------------------------------

N_MUTATIONS = 10_000
ROW_CAP = 1 << 20  # generous cap: bounds allocations, not the fuzz space


def _valid_blobs(rng):
    """A few structurally distinct valid blobs (array, bitmap, multi-key)."""
    rows = np.array([0, 0, 1, 1, 1])
    cols = np.array([1, 5, 0, 70000, SHARD_WIDTH - 1])
    cols_dense = rng.choice(60_000, size=5000, replace=False)
    return [pack_roaring(rows, cols),
            pack_roaring(np.zeros(5000, dtype=np.int64), cols_dense),
            pack_roaring(np.zeros(0, dtype=np.int64),
                         np.zeros(0, dtype=np.int64))]


def _unpack_outcome(mod, blob):
    try:
        rows, cols = mod.unpack_roaring(blob, ROW_CAP)
    except mod.RoaringFormatError as e:
        return None, str(e)
    return (rows.tolist(), cols.tolist()), None


def test_fuzz_unpack_roaring_mutations():
    """Seeded mutations of valid blobs: the port accepts only blobs whose
    bits lie in range, raises only ``RoaringFormatError``, and gives the
    JAX package's outcome on every mutant."""
    rng = np.random.default_rng(1234)
    blobs = _valid_blobs(rng)
    for i in range(N_MUTATIONS):
        blob = bytearray(blobs[i % len(blobs)])
        action = rng.integers(0, 10)
        if action == 0 and len(blob) > 1:
            blob = blob[: rng.integers(0, len(blob))]
        elif action == 1:
            blob += bytes(rng.integers(0, 256, size=8, dtype=np.uint8))
        else:
            for _ in range(int(rng.integers(1, 9))):
                if not blob:
                    break
                blob[rng.integers(0, len(blob))] = int(rng.integers(0, 256))
        blob = bytes(blob)
        try:
            rows, cols = unpack_roaring(blob, ROW_CAP)
            assert (cols >= 0).all() and (cols < SHARD_WIDTH).all()
            assert (rows >= 0).all() and (rows <= ROW_CAP).all()
        except RoaringFormatError:
            pass  # the one allowed failure mode
        except Exception as e:  # pragma: no cover - fuzz failure reporting
            raise AssertionError(
                f"unpack_roaring crashed on mutation {i}: "
                f"{type(e).__name__}: {e}") from e
        assert _unpack_outcome(proaring, blob) == \
            _unpack_outcome(jroaring, blob), i


def test_fuzz_unpack_roaring_garbage():
    rng = np.random.default_rng(99)
    for _ in range(2000):
        n = int(rng.integers(0, 400))
        data = bytes(rng.integers(0, 256, size=n, dtype=np.uint8))
        try:
            unpack_roaring(data, ROW_CAP)
        except RoaringFormatError:
            pass


def test_roaring_roundtrip_property():
    rng = np.random.default_rng(7)
    for _ in range(50):
        n = int(rng.integers(0, 3000))
        rows = rng.integers(0, 64, size=n)
        cols = rng.integers(0, SHARD_WIDTH, size=n)
        blob = pack_roaring(rows, cols)
        assert blob == jroaring.pack_roaring(rows, cols)
        r2, c2 = unpack_roaring(blob, ROW_CAP)
        want = np.unique(rows * SHARD_WIDTH + cols)
        assert np.array_equal(np.sort(r2 * SHARD_WIDTH + c2), want)


def _wal_bytes(records):
    return b"".join(_OP.pack(op, r, c) for op, r, c in records)


def _replay_outcome(frag_cls, buf):
    frag = frag_cls(None, "i", "f", "standard", 0)
    try:
        frag._replay_wal(buf)
    except ValueError:
        return None
    rows, cols = frag.pairs()
    return sorted(zip(np.asarray(rows).tolist(), np.asarray(cols).tolist()))


def test_fuzz_wal_replay():
    """Mutated or truncated WAL buffers replay cleanly or raise
    ``ValueError``, never import out-of-range bits, and replay to the
    JAX package's bits."""
    rng = np.random.default_rng(4321)
    valid = _wal_bytes([
        (_OP_SET, 1, 5), (_OP_SET, 2, 70000), (_OP_CLEAR, 1, 5),
        (_OP_SET, 0, SHARD_WIDTH - 1), (_OP_SET, 3, 12345),
    ])
    for i in range(2000):
        buf = bytearray(valid)
        if rng.integers(0, 6) == 0:
            buf = buf[: rng.integers(0, len(buf))]
        else:
            for _ in range(int(rng.integers(1, 6))):
                buf[rng.integers(0, len(buf))] = int(rng.integers(0, 256))
        got = _replay_outcome(Fragment, bytes(buf))
        if got:
            assert all(r >= 0 and 0 <= c < SHARD_WIDTH for r, c in got)
        assert got == _replay_outcome(jfragment.Fragment, bytes(buf)), i


def test_wal_torn_tail_dropped(tmp_path):
    """A crash mid-append leaves a partial trailing frame: replay drops
    it and recovers everything before it."""
    from pilosa_tpu_torch.storage.fragment import _WAL_FRAME
    from pilosa_tpu_torch.utils.durable import checksum

    path = tmp_path / "frag"
    frag = Fragment(str(path), "i", "f", "standard", 0)
    frag.set_bit(1, 5)
    frag.set_bit(2, 6)
    frag.close()
    payload = _OP.pack(_OP_SET, 3, 7)
    torn = (_WAL_FRAME.pack(len(payload), checksum(payload)) + payload)[:12]
    with open(str(path) + ".wal", "ab") as f:
        f.write(torn)  # header + 4 payload bytes: torn mid-append
    frag2 = Fragment(str(path), "i", "f", "standard", 0)
    assert frag2.quarantined is None
    rows, cols = frag2.pairs()
    assert set(zip(rows.tolist(), cols.tolist())) == {(1, 5), (2, 6)}
    frag2.close()
