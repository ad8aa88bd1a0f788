"""Differential tests: the PyTorch port's container codec and the plain
versions of its two CUDA kernels (pilosa_tpu_torch/ops/containers.py,
ops/kernels.py) against the JAX package's codec and its Pallas kernels.

The Pallas kernels run as tests/test_kernels.py runs them: with the
``container-kernels`` knob set to "pallas" for the test (restored after),
through the Pallas interpreter on the CPU.  To keep that interpretation
cheap the fragments are small (at most 8 rows, 4096 words per row, the
smallest width that still spans two container tiles per row).

Every comparison is EXACT (np.array_equal): words and counts are
integers, so there is no tolerance to state.  Inputs are made with numpy
from a seed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pilosa_tpu.ops import containers as jc  # noqa: E402
from pilosa_tpu.ops import kernels as jk  # noqa: E402
from pilosa_tpu_torch.ops import bitset as tb  # noqa: E402
from pilosa_tpu_torch.ops import containers as tc  # noqa: E402
from pilosa_tpu_torch.ops import kernels as tk  # noqa: E402

CW = 2048
WORDS = 2 * CW          # two container tiles per row
ROWS = 8


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: beside the other test workers on the same
    cores, a full pool of torch threads per worker spins against the
    rest and a case runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas():
    """The JAX kernels' backend knob forced to "pallas" for one test."""
    old = jk.CONTAINER_KERNELS
    jk.CONTAINER_KERNELS = "pallas"
    yield
    jk.CONTAINER_KERNELS = old


def _rand_words(rng, n):
    v = rng.integers(1, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    v[0] = 0x80000000
    if n > 1:
        v[-1] = 0xFFFFFFFF
    return v


def _array_container(rng, tile, n):
    slots = np.sort(rng.choice(CW, n, replace=False))
    return (tile * CW + slots).astype(np.int64), _rand_words(rng, n)


def _run_container(tile, n_runs, width=3):
    """n_runs disjoint runs of ``width`` all-ones words, separated by one
    empty word: n_runs bit runs."""
    w = (np.arange(n_runs)[:, None] * (width + 1)
         + np.arange(width)[None, :]).reshape(-1)
    idx = (tile * CW + w).astype(np.int64)
    return idx, np.full(idx.size, 0xFFFFFFFF, dtype=np.uint32)


def _merge(*parts):
    idx = np.concatenate([p[0] for p in parts])
    val = np.concatenate([p[1] for p in parts])
    order = np.argsort(idx)
    return idx[order], val[order]


def _cases():
    """name -> (idx, val): the boundary packs of the slice's tests."""
    rng = np.random.default_rng(7)
    tiles = ROWS * WORDS // CW
    last = tiles - 1
    cases = {
        "array_1023": _array_container(rng, 3, tc.ARRAY_WORDS_MAX),
        "bitmap_1024": _array_container(rng, 5, tc.ARRAY_WORDS_MAX + 1),
        "run_64": _run_container(2, tc.RUN_MAX),
        "run_65": _run_container(4, tc.RUN_MAX + 1),
        "full_run": (np.arange(CW, dtype=np.int64) + 6 * CW,
                     np.full(CW, 0xFFFFFFFF, dtype=np.uint32)),
        "last_tile": _array_container(rng, last, 17),
        "emptied": (np.zeros(0, np.int64), np.zeros(0, np.uint32)),
    }
    # a partial-word run edge: the run starts and ends mid-word
    i, v = _run_container(9, 5)
    v = v.copy()
    v[0] = 0xFFFF0000
    v[-1] = 0x0000FFFF
    cases["run_partial_words"] = (i, v)
    cases["mixed"] = _merge(
        _array_container(rng, 0, 40), _array_container(rng, 1, 1200),
        _run_container(7, 10), _array_container(rng, last, 3),
        _array_container(rng, 11, 1))
    return cases


CASES = _cases()


def _jax_arrays(p):
    return [jnp.asarray(a) for a in jc.pad_packed(p)]


def _torch_arrays(p, device="cpu"):
    keys, types, counts, offsets, payload = tc.pad_packed(p)
    return [torch.from_numpy(a).to(device) for a in
            (keys, types, counts, offsets)] + \
        [tb.from_numpy(payload, device)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_codec_matches_jax(name):
    idx, val = CASES[name]
    p, q = tc.pack_words(idx, val), jc.pack_words(idx, val)
    for f in ("keys", "types", "counts", "offsets", "payload"):
        assert np.array_equal(getattr(p, f), getattr(q, f)), f
    assert (p.a_max, p.r_max, p.nbytes) == (q.a_max, q.r_max, q.nbytes)
    assert p.type_histogram() == q.type_histogram()
    assert tc.estimate_packed_bytes(idx) == jc.estimate_packed_bytes(idx)
    for a, b in zip(tc.pad_packed(p), jc.pad_packed(q)):
        assert np.array_equal(a, b)
    assert np.array_equal(tc.unpack_packed(p, ROWS, WORDS),
                          jc.unpack_packed(q, ROWS, WORDS))


def test_boundary_forms_are_what_the_cases_claim():
    def hist(name):
        return tc.pack_words(*CASES[name]).type_histogram()
    assert hist("array_1023") == {"array": 1, "bitmap": 0, "run": 0}
    assert hist("bitmap_1024") == {"array": 0, "bitmap": 1, "run": 0}
    assert hist("run_64") == {"array": 0, "bitmap": 0, "run": 1}
    assert hist("run_65")["run"] == 0
    assert hist("full_run") == {"array": 0, "bitmap": 0, "run": 1}
    assert hist("mixed") == {"array": 3, "bitmap": 1, "run": 1}
    p = tc.pack_words(*CASES["last_tile"])
    assert int(p.keys[-1]) == ROWS * WORDS // CW - 1
    # padding entries carry key -1 once the table is bucketed up
    keys = tc.pad_packed(tc.pack_words(*CASES["mixed"]))[0]
    assert keys.size == 8 and (keys[5:] == -1).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_decode_matches_pallas_kernel(name, pallas):
    idx, val = CASES[name]
    p = tc.pack_words(idx, val)
    want = np.asarray(jk.decode_block(
        *_jax_arrays(p), rows=ROWS, words=WORDS,
        a_bucket=tc.pow2_bucket(p.a_max), r_bucket=tc.pow2_bucket(p.r_max)))
    got = tb.to_numpy(tk.decode_block_plain(*_torch_arrays(p), rows=ROWS,
                                            words=WORDS))
    assert np.array_equal(got, want)
    assert np.array_equal(got, tc.unpack_packed(p, ROWS, WORDS))


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("name", ["mixed", "run_64", "bitmap_1024",
                                  "last_tile", "emptied"])
def test_plain_fused_row_counts_matches_pallas_kernel(name, filtered,
                                                      pallas):
    idx, val = CASES[name]
    p = tc.pack_words(idx, val)
    filt = None
    if filtered:
        filt = np.random.default_rng(3).integers(
            0, 1 << 32, size=WORDS, dtype=np.uint64).astype(np.uint32)
        filt[:64] = 0xFFFFFFFF
    want = np.asarray(jk.fused_row_counts(
        *_jax_arrays(p), None if filt is None else jnp.asarray(filt),
        rows=ROWS, words=WORDS, a_bucket=tc.pow2_bucket(p.a_max),
        r_bucket=tc.pow2_bucket(p.r_max)))
    got = tk.fused_row_counts_plain(
        *_torch_arrays(p), None if filt is None else tb.from_numpy(filt,
                                                                   "cpu"),
        rows=ROWS, words=WORDS).numpy()
    assert np.array_equal(got, want)
    dense = tc.unpack_packed(p, ROWS, WORDS)
    if filt is not None:
        dense = dense & filt[None, :]
    assert np.array_equal(got, np.bitwise_count(dense).sum(axis=1))


def _filters(n, seed=5):
    filt = np.random.default_rng(seed).integers(
        0, 1 << 32, size=(n, WORDS), dtype=np.uint64).astype(np.uint32)
    filt[:, :64] = 0xFFFFFFFF
    return filt


# Every boundary case in one ragged stack, in an order that puts shards
# of different container counts and payload sizes side by side.
STACK_NAMES = ["mixed", "emptied", "bitmap_1024", "run_64", "last_tile",
               "array_1023", "run_65", "full_run", "run_partial_words"]


@pytest.fixture(scope="module")
def ragged():
    """(packs, PackedStack on the CPU) of STACK_NAMES."""
    packs = [tc.pack_words(*CASES[n]) for n in STACK_NAMES]
    assert len({p.keys.size for p in packs}) == 3
    assert len({p.payload.size for p in packs}) > 3
    return packs, tc.stack_packed(packs, tc.tiles_of(ROWS, WORDS), "cpu")


def test_stacked_shard_axis_matches_per_shard(ragged):
    """Each shard of a ragged stack decodes and counts as the same
    fragment does alone through the 1-D call form, and as the numpy
    oracle says."""
    packs, st = ragged
    dense = tb.to_numpy(tk.decode_block_plain(*st, rows=ROWS, words=WORDS))
    filt = _filters(len(packs))
    counts = tk.fused_row_counts_plain(
        *st, tb.from_numpy(filt, "cpu"), rows=ROWS, words=WORDS).numpy()
    for i, p in enumerate(packs):
        want = tc.unpack_packed(p, ROWS, WORDS)
        assert np.array_equal(dense[i], want), STACK_NAMES[i]
        one = _torch_arrays(p)
        assert np.array_equal(tb.to_numpy(tk.decode_block_plain(
            *one, rows=ROWS, words=WORDS)), want)
        assert np.array_equal(
            counts[i], np.bitwise_count(want & filt[i][None, :]).sum(axis=1))
        assert np.array_equal(counts[i], tk.fused_row_counts_plain(
            *one, tb.from_numpy(filt[i], "cpu"), rows=ROWS,
            words=WORDS).numpy())


@pytest.mark.parametrize("filtered", [False, True])
def test_ragged_stack_matches_pallas_per_fragment(ragged, filtered, pallas):
    packs, st = ragged
    filt = _filters(len(packs), seed=11) if filtered else None
    dense = tb.to_numpy(tk.decode_block_plain(*st, rows=ROWS, words=WORDS))
    counts = tk.fused_row_counts_plain(
        *st, None if filt is None else tb.from_numpy(filt, "cpu"),
        rows=ROWS, words=WORDS).numpy()
    for i, p in enumerate(packs):
        buckets = dict(a_bucket=tc.pow2_bucket(p.a_max),
                       r_bucket=tc.pow2_bucket(p.r_max))
        if not filtered:
            want = np.asarray(jk.decode_block(
                *_jax_arrays(p), rows=ROWS, words=WORDS, **buckets))
            assert np.array_equal(dense[i], want), STACK_NAMES[i]
        want = np.asarray(jk.fused_row_counts(
            *_jax_arrays(p), None if filt is None else jnp.asarray(filt[i]),
            rows=ROWS, words=WORDS, **buckets))
        assert np.array_equal(counts[i], want), STACK_NAMES[i]


def test_ragged_layout_is_exact_and_aligned(ragged):
    """No pow2 padding: every container keeps its own payload words at a
    16-byte aligned offset; the slot map points each tile at its
    container; padded tables stack as their unpadded pack does."""
    packs, st = ragged
    tiles = tc.tiles_of(ROWS, WORDS)
    assert tuple(st.slots.shape) == (len(packs), tiles)
    assert st.offsets.dtype == torch.int64
    assert int(st.types.numel()) == sum(p.keys.size for p in packs)
    sizes = np.where(st.types.numpy() == tc.TYPE_BITMAP, CW,
                     2 * st.counts.numpy())
    assert (st.offsets.numpy() % tc.PAYLOAD_ALIGN == 0).all()
    assert st.payload.numel() == int((-(-sizes // 4) * 4).sum())
    pay = tb.to_numpy(st.payload)
    for i, p in enumerate(packs):
        for k, t, off in zip(p.keys, p.types, p.offsets):
            ci = int(st.slots[i, k])
            assert int(st.types[ci]) == t
            size = CW if t == tc.TYPE_BITMAP else 2 * int(st.counts[ci])
            o = int(st.offsets[ci])
            assert np.array_equal(pay[o: o + size],
                                  p.payload[off: off + size])
        assert int((st.slots[i] >= 0).sum()) == p.keys.size
    padded = tc.Packed(*tc.pad_packed(packs[0]), 0, 0)
    for a, b in zip(tc.stack_packed([padded], tiles, "cpu"),
                    tc.stack_packed(packs[:1], tiles, "cpu")):
        assert torch.equal(a, b)


def test_slot_map_drops_keys_beyond_rows():
    """A pack built at a larger row capacity (a write that raced the
    stack's signature) loses the tiles past the stack's rows, as the
    JAX decode's drop mode and the dense path's slice to shape do."""
    idx, val = CASES["mixed"]
    wide = np.concatenate([idx, idx[:50] + ROWS * WORDS])
    wval = np.concatenate([val, val[:50]])
    p = tc.pack_words(wide, wval)
    tiles = tc.tiles_of(ROWS, WORDS)
    assert int(p.keys.max()) >= tiles
    st = tc.stack_packed([tc.pack_words(*CASES["run_64"]), p], tiles,
                         "cpu")
    assert int(st.slots.max()) == st.types.numel() - 1
    assert int((st.slots[1] >= 0).sum()) == int((p.keys < tiles).sum())
    got = tb.to_numpy(tk.decode_block_plain(*st, rows=ROWS, words=WORDS))
    assert np.array_equal(got[1], tc.unpack_packed(
        tc.pack_words(idx, val), ROWS, WORDS))
    assert np.array_equal(got[0], tc.unpack_packed(
        tc.pack_words(*CASES["run_64"]), ROWS, WORDS))


def test_cpu_wrappers_take_the_plain_version_without_launching():
    tk.reset_launches()
    p = tc.pack_words(*CASES["mixed"])
    arrs = _torch_arrays(p)
    got = tk.decode_block(*arrs, rows=ROWS, words=WORDS)
    assert np.array_equal(tb.to_numpy(got), tc.unpack_packed(p, ROWS, WORDS))
    cnt = tk.fused_row_counts(*arrs, None, rows=ROWS, words=WORDS)
    assert np.array_equal(cnt.numpy(), np.bitwise_count(
        tc.unpack_packed(p, ROWS, WORDS)).sum(axis=1))
    assert tk.LAUNCHES == {"decode_block": 0, "fused_row_counts": 0}
    assert tk.resolve("cpu") == "torch" and tk.resolve("cuda") == "cuda"


def test_upload_decode_matches_jax(pallas):
    idx, val = CASES["mixed"]
    p = tc.pack_words(idx, val)
    got = tc.upload_decode(p, ROWS, "cpu", words=WORDS)
    want = np.asarray(jc.upload_decode(jc.pack_words(idx, val), ROWS,
                                       words=WORDS))
    assert got.device.type == "cpu"
    assert np.array_equal(tb.to_numpy(got), want)


def test_plain_decode_matches_pallas_on_a_bsi_fragment(pallas):
    """A 22-row BSI fragment (depth 20) at config 4's density — about
    1000 set columns a container, so array containers of 500-1000 words
    — through the plain decode, alone and in a ragged stack of two
    shards, against the JAX Pallas kernel and the dense oracle."""
    from pilosa_tpu.ops import bsi as jbsi
    rng = np.random.default_rng(4)
    dense, packs = [], []
    for _ in range(2):
        cols = np.unique(rng.integers(0, WORDS * 32, size=2000))
        vals = rng.integers(0, 1_000_000, size=cols.size)
        d = jbsi.pack_values(cols, vals, depth=20, words=WORDS)
        flat = d.reshape(-1)
        idx = np.flatnonzero(flat)
        dense.append(d)
        packs.append(tc.pack_words(idx, flat[idx]))
    rows = dense[0].shape[0]
    assert rows == 22
    assert packs[0].type_histogram()["array"] > 0
    for p, d in zip(packs, dense):
        want = np.asarray(jk.decode_block(
            *_jax_arrays(p), rows=rows, words=WORDS,
            a_bucket=tc.pow2_bucket(p.a_max),
            r_bucket=tc.pow2_bucket(p.r_max)))
        assert np.array_equal(want, d)
        got = tk.decode_block_plain(*_torch_arrays(p), rows=rows,
                                    words=WORDS)
        assert np.array_equal(tb.to_numpy(got), want)
    st = tc.stack_packed(packs, tc.tiles_of(rows, WORDS), "cpu")
    got = tk.decode_block(*st, rows=rows, words=WORDS)
    assert np.array_equal(tb.to_numpy(got), np.stack(dense))


# -- the vectorised pack against the JAX module's loop --------------------------

SWEEP_WORDS = 4 * CW    # four container tiles per row


def _same_pack(idx, val, rows, words, dense=None):
    """The port's pack equals the JAX module's field by field, dtypes
    and Python types included, and decodes back to the dense words.
    Returns the port's pack."""
    p, q = tc.pack_words(idx, val), jc.pack_words(idx, val)
    for f in ("keys", "types", "counts", "offsets", "payload"):
        a, b = getattr(p, f), getattr(q, f)
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        assert np.array_equal(a, b), f
    assert (p.a_max, p.r_max) == (q.a_max, q.r_max)
    assert (type(p.a_max), type(p.r_max)) == (type(q.a_max), type(q.r_max))
    if dense is None:
        dense = np.zeros(rows * words, dtype=np.uint32)
        dense[idx] = val
    assert np.array_equal(tc.unpack_packed(p, rows, words),
                          dense.reshape(rows, words))
    return p


def _sweep_store(seed, density, rows, form):
    """(idx int64, val uint32) of a seeded sparse store over ``rows`` x
    SWEEP_WORDS.  ``random``: each word kept with probability
    ``density``, random values, a tenth of them zero.  ``run_heavy``:
    each kept word starts a stretch of all-ones words (some cut
    mid-word), so containers hold few bit runs.  ``bitmap_heavy``: every
    container the random store touches is filled past ARRAY_WORDS_MAX
    words."""
    rng = np.random.default_rng(seed)
    size = rows * SWEEP_WORDS
    keep = rng.random(size) < density
    val = rng.integers(0, 1 << 32, size=size, dtype=np.uint64) \
        .astype(np.uint32)
    val[rng.random(size) < 0.1] = 0
    if form == "run_heavy":
        ones = np.zeros(size + 1, dtype=np.int64)
        at = np.flatnonzero(keep)
        np.add.at(ones, at, 1)
        np.add.at(ones, np.minimum(at + rng.integers(1, 400, at.size),
                                   size), -1)
        keep = np.cumsum(ones[:-1]) > 0
        val[:] = 0xFFFFFFFF
        edge = keep & (rng.random(size) < 0.02)
        val[edge] = np.uint32(0xFFFF0000)
    elif form == "bitmap_heavy":
        touched = np.unique(np.flatnonzero(keep) // CW)
        tile = np.zeros(size // CW, dtype=bool)
        tile[touched] = True
        keep |= np.repeat(tile, CW) & (rng.random(size) < 0.7)
    idx = np.flatnonzero(keep).astype(np.int64)
    return idx, val[idx]


@pytest.mark.parametrize("form", ["random", "run_heavy", "bitmap_heavy"])
@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("density", [0.002, 0.01, 0.2, 0.6, 1.0])
def test_pack_sweep_matches_jax(density, rows, form):
    seed = int(density * 1e4) * 100 + rows
    idx, val = _sweep_store(seed, density, rows, form)
    assert idx.size
    hist = _same_pack(idx, val, rows, SWEEP_WORDS).type_histogram()
    if form == "run_heavy":
        assert hist["run"] > 0, hist
    if form == "bitmap_heavy":
        assert hist["bitmap"] > 0, hist


def _runs_by_bits(n_words, n_runs):
    """One stretch of ``n_words`` slot-adjacent all-ones words (one word
    run) cut into ``n_runs`` bit runs by clearing bit 0 of n_runs - 1
    words spread along it."""
    v = np.full(n_words, 0xFFFFFFFF, dtype=np.uint32)
    v[np.linspace(1, n_words - 1, n_runs - 1).astype(np.int64)] = \
        np.uint32(0xFFFFFFFE)
    return 3 * CW + np.arange(n_words, dtype=np.int64), v


def _boundary_stores():
    """name -> (idx, val, form the pack must choose per container)."""
    rng = np.random.default_rng(13)
    i64 = np.int64

    def array_of(tile, n):
        slots = np.sort(rng.choice(CW, n, replace=False))
        return (tile * CW + slots).astype(i64), _rand_words(rng, n)

    tie = 2 * CW + np.arange(40, dtype=i64)
    return {
        "empty": (np.zeros(0, i64), np.zeros(0, np.uint32), []),
        "zero_words_in_array": (
            np.array([5, 9, 700, 701, 1500], i64),
            np.array([0, 0x55, 0, 0xFFFFFFFF, 3], np.uint32), ["array"]),
        "zero_words_only": (np.array([5, 9, 13], i64),
                            np.zeros(3, np.uint32), ["run"]),
        # no bit run, but more word runs than the prefilter lets through
        "zero_words_past_the_word_run_count": (
            2 * np.arange(tc.RUN_MAX + 1, dtype=i64),
            np.zeros(tc.RUN_MAX + 1, np.uint32), ["array"]),
        "bit_0_and_bit_65535": (
            np.array([CW, 2 * CW - 1], i64),
            np.array([1, 0x80000000], np.uint32), ["array"]),
        "runs_at_bit_0_and_bit_65535": (
            CW + np.array([0, 1, 2, CW - 3, CW - 2, CW - 1], i64),
            np.full(6, 0xFFFFFFFF, np.uint32), ["run"]),
        "run_across_containers": (
            np.arange(CW - 100, CW + 100, dtype=i64),
            np.full(200, 0xFFFFFFFF, np.uint32), ["run", "run"]),
        "word_runs_64": _run_container(1, tc.RUN_MAX) + (["run"],),
        "word_runs_65": _run_container(1, tc.RUN_MAX + 1) + (["array"],),
        "bit_runs_64": _runs_by_bits(200, tc.RUN_MAX) + (["run"],),
        "bit_runs_65": _runs_by_bits(200, tc.RUN_MAX + 1) + (["array"],),
        "tie_is_not_a_run": (tie, np.full(40, 0x00FF0000, np.uint32),
                             ["array"]),
        "array_words_max": array_of(0, tc.ARRAY_WORDS_MAX) + (["array"],),
        "array_words_max_plus_1": array_of(1, tc.ARRAY_WORDS_MAX + 1)
        + (["bitmap"],),
        "full_container": (np.arange(CW, dtype=i64) + 5 * CW,
                           np.full(CW, 0xFFFFFFFF, np.uint32), ["run"]),
        # int64 word values promote the payload as the JAX concatenate does
        "int64_values": (np.array([3, 9, CW + 1, CW + 2, CW + 3], i64),
                         np.array([7, 1, 0xF0, 0x0F, 0xFFFFFFFF], i64),
                         ["array", "array"]),
    }


BOUNDARY = _boundary_stores()
FORM_NAMES = {tc.TYPE_ARRAY: "array", tc.TYPE_BITMAP: "bitmap",
              tc.TYPE_RUN: "run"}


@pytest.mark.parametrize("name", sorted(BOUNDARY))
def test_pack_boundary_matches_jax(name):
    idx, val, forms = BOUNDARY[name]
    p = _same_pack(idx, val, ROWS, WORDS)
    assert [FORM_NAMES[int(t)] for t in p.types] == forms
    if not forms:
        assert p.payload.dtype == np.uint32 and p.payload.size == 0
        assert (p.a_max, p.r_max) == (0, 0)


@pytest.mark.parametrize("route", ["fragment", "qwire"])
def test_pack_of_int64_stores_matches_jax(route):
    """The two callers' stores: a port Fragment's sorted int64 word
    indices (storage/fragment.py) and the binary wire's
    ``np.flatnonzero`` of one segment, cast to int64 (qwire.py)."""
    from pilosa_tpu_torch.core import SHARD_WORDS
    rows = 3
    idx, val = _sweep_store(29, 0.02, rows * SHARD_WORDS // SWEEP_WORDS,
                            "run_heavy")
    dense = np.zeros(rows * SHARD_WORDS, dtype=np.uint32)
    dense[idx] = val
    if route == "fragment":
        from pilosa_tpu_torch.storage import Holder
        f = Holder(None).create_index("i").create_field("f")
        fr = f._create_view_if_not_exists("standard") \
            .create_fragment_if_not_exists(0)
        for r in range(rows):
            fr.set_row(r, dense[r * SHARD_WORDS: (r + 1) * SHARD_WORDS])
        idx, val = fr._idx, fr._val
        assert idx.dtype == np.int64
        p = _same_pack(idx, val, rows, SHARD_WORDS, dense)
        assert np.array_equal(fr.packed_host().payload, p.payload)
    else:
        idx = np.flatnonzero(dense)
        _same_pack(idx.astype(np.int64), dense[idx], rows, SHARD_WORDS,
                   dense)
