"""The port's payload formatter held against numpy and the JAX package.

Tolerance: none.  ``iotml_torch.serve.fastfmt.format_rows`` (the C++
engine) and ``format_rows_plain`` (its per-element plain version) must
equal ``np.array2string`` and ``iotml.serve.fastfmt.format_rows`` byte
for byte on every input of tests/test_fastfmt.py: the payload format is
a wire contract (reference OutputCallback payloads, cardata-v3.py:247).
"""

import numpy as np
import pytest

from iotml.serve.fastfmt import format_rows as j_format_rows
from iotml_torch.serve import fastfmt
from iotml_torch.stream import native


def _adversarial():
    rng = np.random.default_rng(4)
    vals = np.array([0.0, 1e-4, 9.9e-5, 1e8 - 1, 1e8, -0.5, 123.456,
                     0.1, 1/3, 2/3, 1e3, 999.0, 1001.0], np.float64)
    rows = [rng.choice(vals, size=rng.integers(1, 20))[None, :]
            for _ in range(50)]
    return rows + [vals[None, :].astype(np.float32)]


def _exp_trigger():
    x = np.random.default_rng(3).uniform(-1, 1, (50, 18)).astype(np.float32)
    x[::7, 3] = 3e-05          # tiny → exp format
    x[::11, 5] = 2.5e9         # huge → exp format
    x[::13, 7] = 1.0           # ratio trigger rows
    x[::13, 8] = 2000.0
    return [x]


def _nonfinite():
    x = np.ones((8, 6), np.float32)
    x[1, 2] = np.nan
    x[3, 4] = np.inf
    x[5, 0] = -np.inf
    return [x]


def _mixed():
    x = np.random.default_rng(13).uniform(-1, 1, (60, 12)).astype(np.float32)
    x[5, 0] = np.nan
    x[17, 3] = np.inf
    x[23, 7] = 5e9
    x[31, 2] = 1e-6
    return [x]


def _fuzz():
    rng = np.random.default_rng(11)
    out = []
    for _ in range(20):
        rows = rng.normal(size=(40, 18)) * 10.0 ** rng.integers(-3, 7)
        out += [rows.astype(np.float32), rows]
    return out


def _wrap():
    rng = np.random.default_rng(7)
    out = []
    for f in (18, 19, 29, 30, 31, 60, 100, 200):
        out += [rng.uniform(-9.99, 9.99, (20, f)).astype(np.float32),
                rng.uniform(-9.99, 9.99, (8, f))]
    return out


_TIES = np.array([[1 / 512, 3 / 512, 5 / 512, 255 / 512],
                  [7 / 512, 9 / 512, 11 / 512, 201 / 512]])

CASES = {
    "typical": lambda: [np.random.default_rng(0).uniform(
        -1, 1, (500, 18)).astype(np.float32)],
    "relu_zeros": lambda: [np.maximum(np.random.default_rng(1).normal(
        size=(200, 18)), 0.0).astype(np.float32)],
    "wide_and_narrow": lambda: [np.random.default_rng(2).uniform(
        -5, 5, (50, f)).astype(np.float32) for f in (1, 2, 5, 30, 64)],
    "exp_trigger": _exp_trigger,
    "nonfinite": _nonfinite,
    "adversarial": _adversarial,
    "float64": lambda: [np.random.default_rng(5).normal(size=(100, 12))],
    "integer_valued": lambda: [
        np.array([[0.0, 1.0, 2.0, 100.0, -3.0]], np.float32),
        np.zeros((3, 18), np.float32)],
    "decimal_ties": lambda: [_TIES, _TIES.astype(np.float32)],
    "f32_vs_f64_precision": lambda: [
        np.array([[np.nextafter(np.float32(1.0), np.float32(2.0)),
                   np.float32(0.1)]], np.float32),
        np.array([[np.nextafter(1.0, 2.0), 0.1]])],
    "negative_zero": lambda: [
        np.array([[-0.0, 0.0, 1.0, -100.0, 25.0, 1e7]]),
        np.array([[-0.0, 0.0, 1.0, -100.0]], np.float32)],
    "eligibility_bounds": lambda: [
        np.array([[9.9999999e7, 12345.0]]), np.array([[1.00000001e8, 12345.0]]),
        np.array([[1.0e-4, 0.002]]), np.array([[0.99999e-4, 0.002]]),
        np.array([[1.0, 999.99]]), np.array([[1.0, 1000.01]])],
    "wrap_long_rows": _wrap,
    "fuzz": _fuzz,
    "mixed_fallback": _mixed,
    "float16": lambda: [np.random.default_rng(8).uniform(
        -1, 1, (10, 6)).astype(np.float16)],
}


def _check(rows):
    want = [np.array2string(r) for r in rows]
    before = native.stats["format_rows"]
    assert fastfmt.format_rows(rows) == want
    # the engine formats exactly the rows of the plain version's rule
    engine_takes = rows.dtype in (np.float32, np.float64) and \
        fastfmt._options_are_default()
    assert native.stats["format_rows"] - before == \
        (int(fastfmt.fast_rows(rows).sum()) if engine_takes else 0)
    assert fastfmt.format_rows_plain(rows) == want
    assert j_format_rows(rows) == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_format_rows_byte_identical(case):
    for rows in CASES[case]():
        _check(rows)


def test_non_default_printoptions_take_numpy():
    x = np.random.default_rng(6).uniform(-1, 1, (5, 8)).astype(np.float32)
    with np.printoptions(precision=3):
        _check(x)


def test_engine_carries_the_eligible_rows():
    """format_rows is the engine: it counts the rows it formatted, and
    the rows it flags go to numpy."""
    x = np.random.default_rng(9).uniform(0.5, 1, (40, 18)).astype(np.float32)
    x[3, 0] = np.nan
    before = native.stats["format_rows"]
    assert fastfmt.format_rows(x) == [np.array2string(r) for r in x]
    assert native.stats["format_rows"] - before == 39


def test_engine_is_faster_than_numpy():
    import time

    rows = np.random.default_rng(7).uniform(-1, 1, (2000, 18)).astype(
        np.float32)
    fastfmt.format_rows(rows[:1])  # the build is not the formatter's time
    t0 = time.perf_counter()
    fastfmt.format_rows(rows)
    fast = time.perf_counter() - t0
    t0 = time.perf_counter()
    [np.array2string(r) for r in rows]
    base = time.perf_counter() - t0
    assert fast < base, f"engine slower than numpy: {fast} vs {base}"
