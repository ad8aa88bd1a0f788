"""Storage hand-over between the JAX package and the PyTorch port:
``pilosa_tpu_torch.convert.holder_from_arrays`` (a port holder built from
the plain arrays read out of a JAX holder) and the on-disk data directory
(snapshots + WAL), which either package must open as the other wrote it.

Every comparison is EXACT (np.array_equal / result ``to_dict()``
equality): the sparse word stores, schemas and query answers are
integers and strings, so there is no tolerance to state.  Inputs are made
with numpy from a seed.
"""

from datetime import datetime

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu.core import SHARD_WIDTH  # noqa: E402
from pilosa_tpu.executor import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.storage import FieldOptions as JaxFieldOptions  # noqa: E402
from pilosa_tpu.storage import Holder as JaxHolder  # noqa: E402
from pilosa_tpu_torch.convert import holder_from_arrays  # noqa: E402
from pilosa_tpu_torch.executor import Executor  # noqa: E402
from pilosa_tpu_torch.storage import FieldOptions, Holder  # noqa: E402

N_SHARDS = 3
QUERIES = [
    "Count(Row(a=1))",
    "Row(a=2)",
    "Count(Intersect(Row(a=1), Row(m=2)))",
    "Union(Row(a=0), Row(m=1))",
    "Count(Not(Row(a=3)))",
    "TopN(a, n=4)",
    "TopN(a, Row(m=0), n=3)",
    "Rows(m)",
    "GroupBy(Rows(m), Rows(a), Row(a=1))",
    "Count(Row(t=1, from='2020-01-01T00:00', to='2020-02-01T00:00'))",
]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: beside the other test workers on the same
    cores, a full pool of torch threads per worker spins against the
    rest and a case runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fill(holder, field_options):
    """The same writes into a JAX or a port holder (both expose the same
    storage API): a set field, a mutex field, a time field, an int field
    and existence, over N_SHARDS shards."""
    rng = np.random.default_rng(11)
    idx = holder.create_index("s")
    a = idx.create_field("a")
    m = idx.create_field("m", field_options(type="mutex"))
    t = idx.create_field("t", field_options(type="time", time_quantum="YMD"))
    v = idx.create_field("v", field_options(type="int", min=-900, max=900))
    n = 4000
    cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, size=n)
    a.import_bits(rng.integers(0, 9, size=n), cols)
    m.import_bits(rng.integers(0, 4, size=n), cols)
    for r, c, d in zip(rng.integers(0, 3, 50), cols[:50],
                       rng.integers(1, 28, 50)):
        t.set_bit(int(r), int(c), ts=datetime(2020, 1, int(d)))
    vc = np.unique(cols[: n // 2])
    v.import_values(vc, rng.integers(-900, 900, size=vc.size))
    idx.add_existence(cols)
    # single-bit writes after the bulk imports ride the WAL
    for r, c in zip(rng.integers(0, 9, 30), rng.integers(0, SHARD_WIDTH, 30)):
        a.set_bit(int(r), int(c))
    a.clear_bit(1, int(cols[0]))
    return idx, vc


def _arrays_of_jax_holder(h):
    """(schema, fragments) in holder_from_arrays' format, read out of a
    JAX holder as plain Python / numpy values."""
    schema = {}
    for ispec in h.schema():
        schema[ispec["name"]] = {
            "keys": ispec["options"]["keys"],
            "trackExistence": ispec["options"]["trackExistence"],
            "fields": {f["name"]: f["options"] for f in ispec["fields"]}}
    fragments = {}
    for iname, fname, vname, shard, frag in h.iter_fragments():
        fragments[(iname, fname, vname, shard)] = (
            frag._idx.copy(), frag._val.copy(), frag.n_rows)
    return schema, fragments


def _assert_same_storage(jh, th):
    assert jh.schema() == th.schema()
    jf = {k[:4]: k[4] for k in jh.iter_fragments()}
    tf = {k[:4]: k[4] for k in th.iter_fragments()}
    assert sorted(jf) == sorted(tf)
    for key, fj in jf.items():
        ft = tf[key]
        assert np.array_equal(fj._idx, ft._idx), key
        assert np.array_equal(fj._val, ft._val), key
        assert fj.n_rows == ft.n_rows, key


def _norm(results):
    return [r.to_dict() if hasattr(r, "to_dict")
            else [x.to_dict() for x in r] if isinstance(r, list) else r
            for r in results]


def _assert_same_answers(jh, th):
    jex = JaxExecutor(jh)
    for stacked in (False, True):
        tex = Executor(th, device="cpu", stacked=stacked)
        for q in QUERIES:
            assert _norm(tex.execute("s", q)) == _norm(jex.execute("s", q)), \
                (stacked, q)
        tex.close()


def test_holder_from_arrays_matches_the_jax_holder():
    jh = JaxHolder(None)
    _, vcols = _fill(jh, JaxFieldOptions)
    schema, fragments = _arrays_of_jax_holder(jh)
    th = holder_from_arrays(schema, fragments, device="cpu")
    _assert_same_storage(jh, th)
    jv, tv = jh.field("s", "v"), th.field("s", "v")
    for c in vcols[:50]:
        assert tv.value(int(c)) == jv.value(int(c))
    # every fragment's dense mirror was staged on the requested device
    for *_k, frag in th.iter_fragments():
        assert frag._mirrors and \
            next(iter(frag._mirrors.values())).device.type == "cpu"
    _assert_same_answers(jh, th)


def test_holder_from_arrays_rejects_malformed_stores():
    schema = {"i": {"trackExistence": False, "fields": {"f": {}}}}
    bad = {("i", "f", "standard", 0): (np.array([5, 3]),
                                       np.array([1, 1], np.uint32))}
    with pytest.raises(ValueError):
        holder_from_arrays(schema, bad)
    with pytest.raises(KeyError):
        holder_from_arrays(schema, {("i", "g", "standard", 0): (
            np.array([1]), np.array([1], np.uint32))})


def test_jax_data_dir_opens_in_the_port(tmp_path):
    path = str(tmp_path / "data")
    jh = JaxHolder(path)
    jh.open()
    _fill(jh, JaxFieldOptions)
    # the JAX holder stays open: its last single-bit writes live only in
    # the WAL, which the port must replay
    th = Holder(path)
    th.open()
    _assert_same_storage(jh, th)
    _assert_same_answers(jh, th)
    th.close()
    jh.close()


def test_port_data_dir_opens_in_jax(tmp_path):
    path = str(tmp_path / "data")
    th = Holder(path)
    th.open()
    _fill(th, FieldOptions)
    jh = JaxHolder(path)
    jh.open()
    _assert_same_storage(jh, th)
    _assert_same_answers(jh, th)
    jh.close()
    th.close()
    # after a clean close (snapshot + WAL truncation) both still agree
    jh2, th2 = JaxHolder(path), Holder(path)
    jh2.open()
    th2.open()
    _assert_same_storage(jh2, th2)
    jh2.close()
    th2.close()
