"""Roaring format fidelity of the PyTorch port
(pilosa_tpu_torch/storage/roaring_io.py) against the JAX package's: the
counterpart of tests/test_roaring_golden.py.

Read side: the reference's golden images (the two Java-generated hex
images of roaring_internal_test.go:3360 TestUnmarshalRoaringWithNoErrors)
and official-format images built here (runs cookie with its offset
table, an array of exactly 4096 values, and one bitmap container of
10000 bits in place of the reference's
``testdata/bitmapcontainer.roaringbitmap``, which the repo does not
hold) are read by both packages, and the rows and columns must be
equal and the expected bits.

Write side: every packing case (run, array and bitmap thresholds, the
run-heavy multi-row mix, the dense-word bulk packer, the exact
``ARRAY_MAX_SIZE`` boundary) packs the same seeded bits in both
packages, and the blobs must be byte-identical and round-trip.
"""

import struct

import numpy as np
import pytest

pytest.importorskip("torch")

from pilosa_tpu.storage import roaring_io as jroaring  # noqa: E402
from pilosa_tpu_torch.core import SHARD_WIDTH, SHARD_WORDS  # noqa: E402
from pilosa_tpu_torch.storage.roaring_io import (  # noqa: E402
    ARRAY_MAX_SIZE, TYPE_ARRAY, TYPE_BITMAP, TYPE_RUN, pack_roaring,
    pack_roaring_words, unpack_roaring)


def _positions(rows, cols):
    return sorted(int(r) * SHARD_WIDTH + int(c) for r, c in zip(rows, cols))


def _container_types(blob):
    n = struct.unpack_from("<I", blob, 4)[0]
    return [struct.unpack_from("<QHH", blob, 8 + i * 12)[1]
            for i in range(n)]


def _official_blob(containers, with_runs):
    """Build an official-roaring blob: containers = [(key, kind, data)]
    with kind in {'array','bitmap','run'}; data = values array for
    array/bitmap, [(start, length-1)] for run."""
    n = len(containers)
    out = bytearray()
    if with_runs:
        out += struct.pack("<I", 12347 | ((n - 1) << 16))
        flags = bytearray((n + 7) // 8)
        for i, (_, kind, _d) in enumerate(containers):
            if kind == "run":
                flags[i // 8] |= 1 << (i % 8)
        out += flags
    else:
        out += struct.pack("<I", 12346)
        out += struct.pack("<I", n)
    payloads = []
    for key, kind, data in containers:
        if kind == "array":
            card = len(data)
            payloads.append(np.asarray(data, dtype="<u2").tobytes())
        elif kind == "bitmap":
            card = len(data)
            words = np.zeros(1024, dtype="<u8")
            v = np.asarray(data, dtype=np.int64)
            np.bitwise_or.at(words, v >> 6,
                             np.uint64(1) << (v & 63).astype(np.uint64))
            payloads.append(words.tobytes())
        else:  # run: [(start, len-1)], card = total bits
            card = sum(l1 + 1 for _, l1 in data)
            payloads.append(
                struct.pack("<H", len(data))
                + np.asarray(data, dtype="<u2").tobytes())
        out += struct.pack("<HH", key, card - 1)
    if not with_runs or n >= 4:  # NO_OFFSET_THRESHOLD
        off = len(out) + 4 * n
        for p in payloads:
            out += struct.pack("<I", off)
            off += len(p)
    for p in payloads:
        out += p
    return bytes(out)


def _runs_with_offsets():
    """Official spec: the runs cookie carries an offset table once there
    are >= 4 containers; a sequential-only reader decodes garbage."""
    blob = _official_blob([
        (0, "run", [(10, 4)]),             # bits 10..14
        (1, "array", [1, 2, 3]),
        (2, "bitmap", list(range(0, 65536, 13))),
        (3, "run", [(100, 0), (200, 1)]),  # bits 100, 200, 201
    ], with_runs=True)
    want = (list(range(10, 15))
            + [65536 + v for v in (1, 2, 3)]
            + [2 * 65536 + v for v in range(0, 65536, 13)]
            + [3 * 65536 + v for v in (100, 200, 201)])
    return blob, sorted(want)


def _array_4096():
    """Official arrays hold up to 4096 values inclusive (bitmap only
    above); a strict < reader misreads the 8192-byte payload."""
    vals = list(range(0, 8192, 2))
    return _official_blob([(0, "array", vals)], with_runs=False), vals


def _bitmap_10000():
    vals = list(range(0, 50000, 5))
    return _official_blob([(0, "bitmap", vals)], with_runs=False), vals


GOLDEN = {
    # Java-generated official image: bits [1 2 3 65537]
    "official_arrays": lambda: (bytes.fromhex(
        "3A300000020000000000020001000000180000001E0000000100020003000100"),
        [1, 2, 3, 65537]),
    # Java-generated official image with a run container: 1..10, 65537
    "official_run_and_array": lambda: (bytes.fromhex(
        "3B3001000100000900010000000100010009000100"),
        list(range(1, 11)) + [65537]),
    "runs_cookie_offset_table": _runs_with_offsets,
    "array_at_exactly_4096": _array_4096,
    "bitmap_container_10000": _bitmap_10000,
}


@pytest.mark.parametrize("name", list(GOLDEN))
def test_golden_read_matches_jax(name):
    blob, want = GOLDEN[name]()
    rows, cols = unpack_roaring(blob)
    assert _positions(rows, cols) == want
    jrows, jcols = jroaring.unpack_roaring(blob)
    assert np.array_equal(rows, jrows) and np.array_equal(cols, jcols)


def _pack_both(rows, cols):
    """The port's blob, required byte-identical to the JAX package's."""
    blob = pack_roaring(rows, cols)
    assert blob == jroaring.pack_roaring(rows, cols)
    return blob


def test_pack_emits_run_when_runs_win():
    # one solid run of 10k bits: 1 run beats a 10000-entry array and bitmap
    cols = np.arange(10_000, dtype=np.int64)
    rows = np.zeros_like(cols)
    blob = _pack_both(rows, cols)
    assert all(t == TYPE_RUN for t in _container_types(blob))
    assert len(blob) < 100
    r2, c2 = unpack_roaring(blob)
    assert _positions(r2, c2) == _positions(rows, cols)


def test_pack_array_and_bitmap_thresholds():
    rng = np.random.default_rng(7)
    # scattered values, no runs: N < 4096 -> array
    cols = np.sort(rng.choice(65536, size=2000, replace=False))[::2].copy()
    blob = _pack_both(np.zeros(cols.size, dtype=np.int64), cols)
    assert _container_types(blob) == [TYPE_ARRAY]
    # dense scattered: N >= 4096, runs > N/2 -> bitmap (roaring.go:2240)
    cols = np.sort(rng.choice(65536, size=9000, replace=False))
    blob = _pack_both(np.zeros(cols.size, dtype=np.int64), cols)
    assert _container_types(blob) == [TYPE_BITMAP]
    r2, c2 = unpack_roaring(blob)
    assert np.array_equal(np.sort(c2), cols)


def test_pack_run_heavy_mixed_roundtrip():
    """Run-heavy multi-row data round-trips exactly and far below the
    bitmap encoding's size."""
    rng = np.random.default_rng(11)
    rows_l, cols_l = [], []
    for r in range(5):
        start = int(rng.integers(0, 30000))
        cols_l.append(np.arange(start, start + 20000))
        rows_l.append(np.full(20000, r))
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    blob = _pack_both(rows, cols)
    assert TYPE_RUN in _container_types(blob)
    assert len(blob) < 2000, len(blob)
    r2, c2 = unpack_roaring(blob)
    assert _positions(r2, c2) == _positions(rows, cols)


def test_pack_roaring_words_matches_pair_packer():
    """pack_roaring_words emits the blobs of pack_roaring across dense,
    runny, sparse and empty rows, and of the JAX package's packer."""
    rng = np.random.default_rng(4)
    w = np.zeros((5, SHARD_WORDS), dtype=np.uint32)
    w[0] = rng.integers(0, 1 << 32, SHARD_WORDS, dtype=np.uint32) & \
        rng.integers(0, 1 << 32, SHARD_WORDS, dtype=np.uint32)
    w[1, :5000] = 0xFFFFFFFF  # long runs
    for c in rng.choice(SHARD_WORDS * 32, 300, replace=False):
        w[2, c >> 5] |= np.uint32(1 << (c & 31))
    # row 3 stays empty; row 4 fully random (bitmap regime)
    w[4] = rng.integers(0, 1 << 32, SHARD_WORDS, dtype=np.uint32)

    blob = pack_roaring_words(w)
    assert blob == jroaring.pack_roaring_words(w)
    rows_l, cols_l = [], []
    for r in range(5):
        bits = np.unpackbits(w[r].view(np.uint8), bitorder="little")
        nz = np.nonzero(bits)[0]
        rows_l.append(np.full(nz.size, r))
        cols_l.append(nz)
    rows, cols = np.concatenate(rows_l), np.concatenate(cols_l)
    assert blob == _pack_both(rows, cols)
    r2, c2 = unpack_roaring(blob)
    assert _positions(r2, c2) == _positions(rows, cols)


def test_pack_boundary_exact_array_max():
    # exactly ARRAY_MAX_SIZE scattered bits: the reference uses a bitmap
    # at N == ArrayMaxSize (roaring.go:2241 strict <)
    cols = np.arange(0, ARRAY_MAX_SIZE * 2 * 2, 4)[:ARRAY_MAX_SIZE]
    assert cols.size == ARRAY_MAX_SIZE
    blob = _pack_both(np.zeros(cols.size, dtype=np.int64), cols)
    assert _container_types(blob) == [TYPE_BITMAP]
    r2, c2 = unpack_roaring(blob)
    assert np.array_equal(np.sort(c2), cols)
