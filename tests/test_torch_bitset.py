"""Differential tests: the PyTorch port's dense bitset ops
(pilosa_tpu_torch/ops/bitset.py) against the JAX package's
(pilosa_tpu/ops/bitset.py) on the same numpy inputs.

Every comparison is EXACT (np.array_equal / integer equality): words and
counts are integers, so there is no tolerance to state.  Inputs are made
with numpy from a seed and always include the words 0x80000000 (the
int32 sign bit the port's masked shifts must handle) and 0xFFFFFFFF.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pilosa_tpu.ops import bitset as jb  # noqa: E402
from pilosa_tpu_torch.ops import bitset as tb  # noqa: E402

W = 256  # words per segment: small, but every op is width-generic


def _words(rng, *shape):
    """Random uint32 words salted with the boundary patterns."""
    a = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64) \
        .astype(np.uint32)
    flat = a.reshape(-1)
    flat[0] = 0x80000000
    flat[1] = 0xFFFFFFFF
    flat[2] = 0
    flat[3] = 0x7FFFFFFF
    flat[-1] = 0x80000001
    return a


def _t(a):
    return tb.from_numpy(a, "cpu")


def _np(x):
    return np.asarray(x)


def _eq(jax_out, torch_out):
    want = _np(jax_out)
    got = tb.to_numpy(torch_out) if want.dtype == np.uint32 \
        else torch_out.numpy()
    assert np.array_equal(got.astype(want.dtype), want)


@pytest.fixture
def rng():
    return np.random.default_rng(2024)


def test_host_boundary_roundtrip(rng):
    a = _words(rng, 3, W)
    t = _t(a)
    assert t.dtype == torch.int32
    assert np.array_equal(tb.to_numpy(t), a)


@pytest.mark.parametrize("op", ["intersect", "union", "difference", "xor"])
def test_boolean_algebra(rng, op):
    a, b = _words(rng, 4, W), _words(rng, 4, W)
    _eq(getattr(jb, op)(jnp.asarray(a), jnp.asarray(b)),
        getattr(tb, op)(_t(a), _t(b)))


def test_union_many(rng):
    segs = _words(rng, 5, W)
    _eq(jb.union_many(jnp.asarray(segs)), tb.union_many(_t(segs)))


def test_popcount_words_every_bit_pattern_class(rng):
    a = _words(rng, 4096)
    singles = (np.uint32(1) << np.arange(32, dtype=np.uint32))
    a = np.concatenate([a, singles, ~singles])
    got = tb.popcount_words(_t(a)).numpy()
    assert np.array_equal(got, _np(jb.popcount_words(jnp.asarray(a))))
    assert np.array_equal(got, np.bitwise_count(a).astype(np.int32))


def test_counts(rng):
    a, b = _words(rng, 6, W), _words(rng, 6, W)
    assert int(tb.count(_t(a))) == int(jb.count(jnp.asarray(a)))
    assert tb.count_np(a) == int(jb.count(jnp.asarray(a)))
    _eq(jb.row_counts(jnp.asarray(a)), tb.row_counts(_t(a)))
    assert int(tb.intersection_count(_t(a[0]), _t(b[0]))) == \
        int(jb.intersection_count(jnp.asarray(a[0]), jnp.asarray(b[0])))


def test_intersection_counts_matrix_chunked(rng, monkeypatch):
    a, b = _words(rng, 7, W), _words(rng, 5, W)
    want = _np(jb.intersection_counts_matrix(jnp.asarray(a),
                                             jnp.asarray(b)))
    assert np.array_equal(tb.intersection_counts_matrix(_t(a), _t(b))
                          .numpy(), want)
    # force one n-row per chunk: the chunked path must agree exactly
    monkeypatch.setattr(tb, "_PAIR_TEMP_WORDS", 1)
    assert np.array_equal(tb.intersection_counts_matrix(_t(a), _t(b))
                          .numpy(), want)


@pytest.mark.parametrize("start,end", [
    (0, 0), (0, 1), (0, 32), (31, 33), (5, 200), (32, 64), (100, 101),
    (0, W * 32), (W * 32 - 1, W * 32), (63, W * 32 - 40)])
def test_range_ops(rng, start, end):
    seg = _words(rng, W)
    _eq(jb._range_mask(start, end, W), tb._range_mask(start, end, W))
    assert int(tb.count_range(_t(seg), start, end)) == \
        int(jb.count_range(jnp.asarray(seg), start, end))
    _eq(jb.flip(jnp.asarray(seg), start, end), tb.flip(_t(seg), start, end))
    _eq(jb.keep_range(jnp.asarray(seg), start, end),
        tb.keep_range(_t(seg), start, end))


@pytest.mark.parametrize("n", [0, 1, 5, 31, 32, 33, 64, 100, W * 32 - 1,
                               W * 32 + 3])
def test_shift(rng, n):
    seg = _words(rng, 3, W)
    _eq(jb.shift(jnp.asarray(seg), n), tb.shift(_t(seg), n))


@pytest.mark.parametrize("op", ["set_bits", "clear_bits"])
def test_set_clear_bits(rng, op):
    frag = _words(rng, 6, W)
    n = 400
    rows = rng.integers(-1, 7, size=n)          # -1 padding, 6 = past the end
    cols = rng.integers(0, W * 32, size=n)
    cols[:20] = 31                              # many hits on bit 31
    rows[:20] = 2
    cols[20:40] = cols[40:60]                   # duplicate positions
    rows[20:40] = rows[40:60]
    want = _np(getattr(jb, op)(jnp.asarray(frag.copy()),
                               jnp.asarray(rows, jnp.int32),
                               jnp.asarray(cols, jnp.int32)))
    got = getattr(tb, op)(_t(frag), torch.as_tensor(rows),
                          torch.as_tensor(cols))
    assert np.array_equal(tb.to_numpy(got), want)


def test_numpy_pack_helpers_match(rng):
    cols = rng.integers(0, W * 32, size=300)
    rows = rng.integers(0, 5, size=300)
    assert np.array_equal(tb.pack_columns(cols, W), jb.pack_columns(cols, W))
    frag = tb.pack_fragment(rows, cols, 5, W)
    assert np.array_equal(frag, jb.pack_fragment(rows, cols, 5, W))
    assert np.array_equal(tb.unpack_columns(frag[1]),
                          jb.unpack_columns(frag[1]))
    for x, y in zip(tb.unpack_fragment(frag), jb.unpack_fragment(frag)):
        assert np.array_equal(x, y)
    w, bit = tb.word_bit_np(cols)
    w2, bit2 = jb.word_bit_np(cols)
    assert np.array_equal(w, w2) and np.array_equal(bit, bit2)
