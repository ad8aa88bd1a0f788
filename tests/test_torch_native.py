"""The PyTorch port's native fingerprint scanner
(pilosa_tpu_torch/native/fingerprint.c, built with the system ``cc``
into pilosa_tpu_torch/_build/) against the JAX package's C scanner and
the Python regex path of both packages, on the cases and the
differential fuzz of tests/test_native.py.  The scanner sits in front of
the prepared-statement cache on every request: a divergence would
mis-key the cache or mis-extract literals.  Non-ASCII text and literals
beyond int64 take the Python path.  Comparisons are exact."""

import numpy as np
import pytest

from pilosa_tpu.executor.prepared import \
    _fingerprint_py as jax_fingerprint_py  # noqa: E402
from pilosa_tpu.native import \
    fingerprint_native as jax_fingerprint_native  # noqa: E402

torch = pytest.importorskip("torch")

from pilosa_tpu_torch.executor.prepared import (  # noqa: E402
    _fingerprint_py, fingerprint)
from pilosa_tpu_torch.native import fingerprint_native  # noqa: E402

CASES = [
    "Count(Row(stargazer=14)) TopN(language, Row(stars=-3), n=50)",
    "Row(f='ab12cd') Row(g=\"9\") Sum(Row(v > 123456), field=v)",
    "Range(v > 2017-01-01T00:00)",
    "Row(f=1.5) Row(g=field1) Row(h=1a2b)",
    "Set(100, f=2)",
    "Row(f='unterminated 12",
    "Row(f='esc\\'aped 7') Count(Row(g=8))",
]


@pytest.fixture(scope="module")
def native():
    if fingerprint_native("probe") is None:
        pytest.fail("the native fingerprint library did not build: "
                    "this machine has cc")
    return fingerprint_native


def _same(q, nat):
    py_t, py_v = _fingerprint_py(q)
    assert (py_t, py_v) == jax_fingerprint_py(q), q
    assert nat is not None, q
    assert nat[0] == py_t, repr(q)
    assert [int(x) for x in nat[1]] == py_v, repr(q)
    jnat = jax_fingerprint_native(q)
    if jnat is not None:
        assert nat[0] == jnat[0]
        assert np.array_equal(nat[1], jnat[1])


@pytest.mark.parametrize("q", CASES)
def test_native_matches_python_and_jax(native, q):
    _same(q, native(q))


def test_native_overflow_and_non_ascii_fall_back(native):
    q = "Row(x=99999999999999999999)"
    assert native(q) is None
    # the public fingerprint() still answers via the regex path
    t, v = fingerprint(q)
    assert t == "Row(x=?)"
    assert list(v) == [99999999999999999999]
    # \\w matches Unicode word chars in the regex; the byte-wise scanner
    # declines rather than diverge
    assert native("Row(f=Ă 9)") is None
    assert fingerprint("Row(f=Ă 9)") == _fingerprint_py("Row(f=Ă 9)")


def test_overflow_literal_reaches_classic_path():
    """A >int64 literal must not blow up inside the prepared cache's
    int64 params coercion: it falls through to the classic path, which
    reports a clean parse error."""
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.pql.parser import ParseError
    from pilosa_tpu_torch.storage import Holder

    h = Holder(None)
    idx = h.create_index("ovf", track_existence=False)
    idx.create_field("f")
    ex = Executor(h, device="cpu")
    try:
        with pytest.raises(ParseError):
            ex.execute("ovf", "Count(Row(f=99999999999999999999))")
    finally:
        ex.close()


def test_native_differential_fuzz(native):
    rng = np.random.default_rng(11)
    alphabet = list("abzAZ019_.:-'\"\\()=<>, \tRow(stargazer=)Count")
    for _ in range(2000):
        n = int(rng.integers(0, 60))
        s = "".join(rng.choice(alphabet) for _ in range(n))
        _same(s, native(s))
