"""Differential tests: the PyTorch port's dense bitset ops
(pilosa_tpu_torch/ops/bitset.py) and BSI ops (ops/bsi.py) against the
JAX package's (pilosa_tpu/ops/bitset.py, ops/bsi.py) on the same numpy
inputs.  The BSI cases are those of tests/test_bsi.py, plus the
``_dyn`` forms over a batch axis of predicates.

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
from pilosa_tpu.ops import bsi as jbsi  # noqa: E402
from pilosa_tpu_torch.ops import bitset as tb  # noqa: E402
from pilosa_tpu_torch.ops import bsi as tbsi  # noqa: E402

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


# -- BSI (tests/test_bsi.py's cases) ------------------------------------------

DEPTH = 16
BSI_OPS = {
    "eq": lambda v, p: v == p,
    "neq": lambda v, p: v != p,
    "lt": lambda v, p: v < p,
    "le": lambda v, p: v <= p,
    "gt": lambda v, p: v > p,
    "ge": lambda v, p: v >= p,
}
PREDS = [-70000, -4999, -123, -1, 0, 1, 57, 4999, 70000]


def _bsi_make(rng, n=300, lo=-5000, hi=5000, depth=DEPTH):
    cols = np.unique(rng.integers(0, W * 32, size=n))
    vals = rng.integers(lo, hi, size=cols.size)
    return cols, vals, jbsi.pack_values(cols, vals, depth=depth, words=W)


def _mag_bits(v: int) -> np.ndarray:
    return np.asarray([(abs(v) >> i) & 1 for i in range(tbsi.MAG_BITS)],
                      dtype=np.int32)


def _sign(v: int) -> str:
    return "zero" if v == 0 else ("pos" if v > 0 else "neg")


def _cols(seg) -> set:
    return set(tb.unpack_columns(np.asarray(seg)).tolist())


def test_bsi_pack_values_match(rng):
    cols, vals, frag = _bsi_make(rng)
    assert np.array_equal(tbsi.pack_values(cols, vals, DEPTH, W), frag)
    for x, y in zip(tbsi.unpack_values(frag), jbsi.unpack_values(frag)):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("op", list(BSI_OPS))
@pytest.mark.parametrize("pred", PREDS)
def test_bsi_range_op_matches_jax(rng, op, pred):
    """range_op and range_op_dyn (one predicate) against the JAX ops and
    the dict oracle."""
    cols, vals, frag = _bsi_make(rng)
    want = _np(jbsi.range_op(frag, op, pred))
    _eq(want, tbsi.range_op(_t(frag), op, pred))
    _eq(jbsi.range_op_dyn(frag, op, _sign(pred), jnp.asarray(_mag_bits(pred))),
        tbsi.range_op_dyn(_t(frag), op, _sign(pred),
                          torch.as_tensor(_mag_bits(pred))))
    assert _cols(want) == {int(c) for c, v in zip(cols, vals)
                           if BSI_OPS[op](v, pred)}


def test_bsi_range_op_zero_with_negative_zero_sign():
    # A column whose magnitude is 0 but sign bit is set still holds value 0.
    frag = np.zeros((2 + 4, W), dtype=np.uint32)
    frag[tbsi.EXISTS_ROW, 0] = 0b1
    frag[tbsi.SIGN_ROW, 0] = 0b1
    for op, pred, want in (("eq", 0, {0}), ("lt", 0, set()),
                           ("gt", -1, {0})):
        got = tbsi.range_op(_t(frag), op, pred)
        assert _cols(tb.to_numpy(got)) == want
        _eq(jbsi.range_op(frag, op, pred), got)
        _eq(jbsi.range_op(frag, op, pred),
            tbsi.range_op_dyn(_t(frag), op, _sign(pred),
                              torch.as_tensor(_mag_bits(pred))))


def test_bsi_range_between(rng):
    cols, vals, frag = _bsi_make(rng)
    for lo, hi in ((-100, 250), (-4000, -5), (7, 7), (6000, 9000)):
        want = _np(jbsi.range_between(frag, lo, hi))
        _eq(want, tbsi.range_between(_t(frag), lo, hi))
        _eq(want, tbsi.range_between_dyn(
            _t(frag), _sign(lo), torch.as_tensor(_mag_bits(lo)),
            _sign(hi), torch.as_tensor(_mag_bits(hi))))
        assert _cols(want) == {int(c) for c, v in zip(cols, vals)
                               if lo <= v <= hi}


@pytest.mark.parametrize("filtered", [False, True])
def test_bsi_sum_matches_jax(rng, filtered):
    cols, vals, frag = _bsi_make(rng)
    keep = cols[: cols.size // 2] if filtered else cols
    filt = jb.pack_columns(keep, words=W) if filtered else None
    want = _np(jbsi.sum_counts(frag, filt))
    got = tbsi.sum_counts(_t(frag), None if filt is None else _t(filt))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    s, n = tbsi.weighted_sum(got.numpy())
    assert (s, n) == jbsi.weighted_sum(want)
    assert (s, n) == (int(vals[: keep.size].sum()), keep.size)


def _min_max_both(frag, filt, want_max):
    want = jbsi.reconstruct_min_max(*[np.asarray(x) for x in
                                      jbsi.min_max_bits(frag, filt,
                                                        want_max=want_max)])
    out = tbsi.min_max_bits(_t(frag), None if filt is None else _t(filt),
                            want_max=want_max)
    got = tbsi.reconstruct_min_max(*[x.numpy() for x in out])
    assert got == want
    return got


@pytest.mark.parametrize("want_max", [False, True])
def test_bsi_min_max_matches_jax(rng, want_max):
    cols, vals, frag = _bsi_make(rng)
    target = int(vals.max() if want_max else vals.min())
    assert _min_max_both(frag, None, want_max) == \
        (target, int((vals == target).sum()))
    # with a filter
    cols = np.array([1, 2, 3, 4])
    frag = jbsi.pack_values(cols, np.array([10, -20, 30, -40]), depth=8,
                            words=W)
    filt = jb.pack_columns(np.array([1, 3]), words=W)
    assert _min_max_both(frag, filt, want_max) == \
        ((30, 1) if want_max else (10, 1))


@pytest.mark.parametrize("case", [
    [5, 7, 9], [-5, -7, -9], [-5, 0, 5], [0], [-3, -3, 8],
])
def test_bsi_min_max_small(case):
    frag = jbsi.pack_values(np.arange(len(case)), np.array(case), depth=8,
                            words=W)
    for want_max in (False, True):
        target = max(case) if want_max else min(case)
        assert _min_max_both(frag, None, want_max) == \
            (target, case.count(target))


def test_bsi_min_max_empty_returns_zero_count():
    frag = np.zeros((2 + 4, W), dtype=np.uint32)
    assert _min_max_both(frag, None, False) == (0, 0)


def test_bsi_dyn_forms_over_a_batch_of_predicates(rng):
    """The ``_dyn`` forms with a ``[B, 63]`` bit tensor over a ``[S,
    rows, W]`` stack: each batch row equals its predicate run alone
    (JAX, per shard) — for one sign per batch, as a slot fixes it —
    and so do sum_counts under the ``[B, S, W]`` result as a filter and
    min_max_bits per shard."""
    S = 3
    frags = np.stack([_bsi_make(rng)[2] for _ in range(S)])
    stack = _t(frags)
    for sign, preds in (("pos", [1, 57, 4999, 70000, 300]),
                        ("neg", [-1, -123, -4999, -70000])):
        bits = torch.as_tensor(np.stack([_mag_bits(p) for p in preds]))
        for op in BSI_OPS:
            got = tbsi.range_op_dyn(stack, op, sign, bits)
            assert tuple(got.shape) == (len(preds), S, W)
            for b, p in enumerate(preds):
                for s in range(S):
                    _eq(jbsi.range_op(frags[s], op, p), got[b, s])
        hi = torch.as_tensor(np.stack([_mag_bits(p + 400)
                                       for p in preds]))
        hi_sign = "pos" if sign == "pos" else "neg"
        btw = tbsi.range_between_dyn(stack, sign, bits, hi_sign, hi)
        sums = tbsi.sum_counts(stack, btw)           # [B, S, 2, depth+1]
        assert tuple(sums.shape) == (len(preds), S, 2, DEPTH + 1)
        for b, p in enumerate(preds):
            if (p + 400 > 0) != (hi_sign == "pos") or p + 400 == 0:
                continue   # the slot's sign would differ from this one
            for s in range(S):
                seg = jbsi.range_between(frags[s], p, p + 400)
                _eq(seg, btw[b, s])
                assert np.array_equal(sums[b, s].numpy(),
                                      _np(jbsi.sum_counts(frags[s], seg)))
    for want_max in (False, True):
        bits, neg, cnt = tbsi.min_max_bits(stack, want_max=want_max)
        for s in range(S):
            want = jbsi.min_max_bits(frags[s], want_max=want_max)
            assert np.array_equal(bits[s].numpy(), _np(want[0]))
            assert int(neg[s]) == int(want[1])
            assert int(cnt[s]) == int(want[2])
